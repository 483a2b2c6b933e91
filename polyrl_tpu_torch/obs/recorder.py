"""Anomaly flight recorder (a copy of ``polyrl_tpu/obs/recorder.py``).

The recorder watches the per-step record
stream with an EWMA/z-score detector over step time and decode throughput
and, on anomaly, crash, or SIGTERM, dumps a self-contained post-mortem
bundle into the run directory:

``<out_dir>/postmortem/<seq>-<reason>/``
    ``spans.jsonl``    — the tracer ring buffer (the last trace_buffer
                         spans across trainer/manager/engine)
    ``steps.jsonl``    — the last ``keep_steps`` step records
    ``stacks.txt``     — ``faulthandler`` dump of every thread's stack
    ``counters.json``  — reason, anomaly details, fault/salvage counters,
                         detector state
    ``engine.json``    — fleet flight-deck view (``engine_fn``; when wired)
    ``training.json``  — training health ledger tail + last batch's GRPO
                         group table (``training_fn``; when wired)
    ``critical_path.json`` — the last N per-step critical paths
                         (obs/critical_path.py via ``critical_path_fn``;
                         when wired) — the bundle answers "what chain
                         bounded the steps before this died"
    ``memory.json``    — the KV memory plane view (rollout/kvledger.py via
                         ``memory_fn``; when wired) — page roles, residency
                         tiers, free-cause churn and the ledger↔pool
                         reconciliation at anomaly time
    ``engine_profile.json`` — the fleet engine-loop profiler view
                         (obs/engine_profile.py via ``engine_profile_fn``;
                         when wired) — per-engine device-vs-host wall
                         split at anomaly time
    ``memory_snapshot.pickle`` — best-effort
                         ``torch.cuda.memory._snapshot()`` of the caching
                         allocator (CUDA only; skipped without a card, and
                         a failure costs only this file)

Detector design: EWMA mean + EW variance with a **median-initialized
warmup** (the first step carries jit compiles — seeding the mean from the
median of the warmup window keeps one cold-start outlier from poisoning
the baseline) and a sigma floor (``min_sigma_frac`` of the mean) so a
near-constant series doesn't hair-trigger on noise. Anomalous samples are
NOT folded into the statistics — one stall yields one anomaly, and the
recovered steps after it read normal again (pinned by test).
"""

from __future__ import annotations

import collections
import faulthandler
import json
import logging
import math
import os
import re
import signal
import threading
import time

log = logging.getLogger(__name__)


DIRECTIONS = ("low", "high", "both")
MEMORY_SNAPSHOT = "memory_snapshot.pickle"


def _write_memory_snapshot(path: str) -> None:
    """The CUDA caching allocator's snapshot (segments, blocks and, where
    history recording is on, their stacks) as ``memory_snapshot.pickle``,
    readable by ``torch.cuda.memory``'s viewer. Skipped without a card; a
    failure costs only this file."""
    try:
        import pickle

        import torch

        if not torch.cuda.is_available():
            return
        snap = torch.cuda.memory._snapshot()
        with open(os.path.join(path, MEMORY_SNAPSHOT), "wb") as f:
            pickle.dump(snap, f)
    except Exception:  # noqa: BLE001 — the snapshot is best-effort
        log.debug("flight recorder: no CUDA memory snapshot", exc_info=True)


def direction_violates(direction: str, excursion: float) -> bool:
    """Shared per-key direction semantics: "is this move in the BAD
    direction". ``excursion`` is any
    signed deviation from the baseline (a z-score, a ratio minus 1):
    ``'high'`` fires on positive excursions (KL blowing up, a latency
    rising), ``'low'`` on negative ones (entropy collapsing, throughput
    dropping), ``'both'`` on either."""
    if direction == "high":
        return excursion > 0.0
    if direction == "low":
        return excursion < 0.0
    if direction == "both":
        return excursion != 0.0
    raise ValueError(f"direction must be one of {DIRECTIONS}, "
                     f"got {direction!r}")


class AnomalyDetector:
    """EWMA/z-score detector for one metric stream. ``direction`` gates
    which excursions COUNT as anomalous: a symmetric detector over
    ``training/entropy`` would fire on a healthy entropy rise exactly as
    on a collapse — only the watched direction fires. Extreme samples in
    the healthy direction still don't fold into the statistics (they are
    outliers either way; the baseline must survive them)."""

    def __init__(self, z_threshold: float = 4.0, warmup: int = 5,
                 alpha: float = 0.3, min_sigma_frac: float = 0.1,
                 direction: str = "both"):
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, "
                             f"got {direction!r}")
        self.z_threshold = z_threshold
        self.warmup = warmup
        self.alpha = alpha
        self.min_sigma_frac = min_sigma_frac
        self.direction = direction
        self.mean: float | None = None
        self.var = 0.0
        self.n = 0
        self._warm: list[float] = []

    def _sigma(self) -> float:
        # floor: EW sigma, but never below min_sigma_frac of |mean| — a
        # perfectly steady warmup must not make ordinary jitter anomalous
        return max(math.sqrt(self.var),
                   self.min_sigma_frac * abs(self.mean or 0.0), 1e-12)

    def observe(self, value: float) -> float | None:
        """Feed one sample; returns its z-score when anomalous, else None.
        Warmup samples are never anomalous; anomalous samples do not
        update the statistics."""
        v = float(value)
        self.n += 1
        if self.mean is None:
            self._warm.append(v)
            if len(self._warm) >= self.warmup:
                # median-initialized baseline: robust to the cold-start
                # outlier (first-step jit compiles) inside the warmup
                srt = sorted(self._warm)
                mid = len(srt) // 2
                med = (srt[mid] if len(srt) % 2
                       else 0.5 * (srt[mid - 1] + srt[mid]))
                self.mean = med
                dev = sorted(abs(x - med) for x in srt)
                mad = (dev[mid] if len(dev) % 2
                       else 0.5 * (dev[mid - 1] + dev[mid]))
                # 1.4826 ~ MAD->sigma for a normal distribution
                self.var = (1.4826 * mad) ** 2
                self._warm = []
            return None
        z = (v - self.mean) / self._sigma()
        if abs(z) > self.z_threshold:
            # extreme either way: never folded into the baseline; only
            # the watched direction is REPORTED as anomalous
            return z if direction_violates(self.direction, z) else None
        a = self.alpha
        delta = v - self.mean
        self.mean += a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)
        return None

    def state(self) -> dict:
        return {"n": self.n, "mean": self.mean, "sigma": self._sigma()
                if self.mean is not None else None,
                "direction": self.direction,
                "warmed": self.mean is not None}


# step-record keys the recorder watches by default, each with the
# direction that IS the anomaly: wall step time (a stall spikes it), the
# rollout plane's decode throughput (a sick pool collapses it), and the
# fleet flight-deck gauges (PoolManager.counters) keep their original
# symmetric watch; the training health plane (obs/rlhealth.py) is
# direction-aware — entropy collapsing DOWN and KL / grad norm /
# degenerate-group fraction blowing UP are the anomalies, their healthy
# moves are not. Keys absent from the step record (no pool attached, no
# health ledger) are simply never fed.
DEFAULT_WATCH = {
    "perf/step_time_s": "both",
    "perf/rollout_throughput_tok_s": "both",
    "engine/occupancy": "both",
    "engine/page_util": "both",
    "training/entropy": "low",
    "training/approx_kl": "high",
    "training/grad_norm": "high",
    "training/degenerate_group_frac": "high",
    # weight-fabric supervision (transfer/agents.py): a cumulative failed-
    # push counter starting to climb means the sync fabric is degrading —
    # only a RISE is the anomaly
    "transfer/push_failures": "high",
    # degradation-tier ladder (rollout/autoscale.py): 0 remote-preferred,
    # 1 colocated fallback, 2 local degraded completion — climbing UP the
    # ladder is the anomaly, recovering back down is healthy
    "autoscale/degrade_tier": "high",
    # KV memory plane (rollout/kvledger.py): the resident set going COLD
    # (pages nobody touches accumulating) is the anomaly — a busy cache
    # keeps its pages warm; HBM headroom only matters when it DROPS
    "engine/kv_cold_page_frac": "high",
    "engine/hbm_headroom_gb": "low",
    # host-RAM spill tier (rollout/kvspill.py): a climbing restore rate
    # means pages are thrashing between host and HBM — spilled pages being
    # pulled straight back means the watermarks are fighting the workload
    "engine/kv_restore_rate": "high",
    # engine-loop profiler (obs/engine_profile.py): device_frac DROPPING
    # means an engine's loop thread stopped feeding the chip (host-bound
    # regression); accounting_frac RISING means the deck/ledger/spill
    # bookkeeping started eating the loop — both one-sided
    "engine/device_frac": "low",
    "engine/accounting_frac": "high",
}


def _normalize_watch(watch) -> dict[str, str]:
    """Watch spec → ``{key: direction}``: a mapping passes through; an
    iterable accepts bare keys (symmetric watch, the pre-direction
    behavior) or ``(key, direction)`` pairs."""
    if isinstance(watch, dict):
        return dict(watch)
    out: dict[str, str] = {}
    for item in watch:
        if isinstance(item, str):
            out[item] = "both"
        else:
            key, direction = item
            out[key] = direction
    return out


class FlightRecorder:
    """Watches the step-record stream; dumps post-mortem bundles."""

    def __init__(self, out_dir: str, keep_steps: int = 64,
                 z_threshold: float = 4.0, warmup: int = 5,
                 alpha: float = 0.3, min_sigma_frac: float = 0.1,
                 max_bundles: int = 4,
                 watch=DEFAULT_WATCH):
        self.out_dir = out_dir
        self.max_bundles = max_bundles
        self._steps: collections.deque = collections.deque(maxlen=keep_steps)
        self._detectors = {
            key: AnomalyDetector(z_threshold=z_threshold, warmup=warmup,
                                 alpha=alpha, min_sigma_frac=min_sigma_frac,
                                 direction=direction)
            for key, direction in _normalize_watch(watch).items()}
        self._lock = threading.Lock()
        self._seq = 0
        self.anomalies = 0        # anomalous STEPS (one per step, not per key)
        self.bundles_dropped = 0  # bundles skipped past max_bundles
        self.bundle_paths: list[str] = []
        # optional zero-arg callable returning cumulative fault counters
        # (RemoteRollout.fault_counters) folded into every bundle
        self.counters_fn = None
        # optional zero-arg callable returning the fleet flight-deck view
        # (PoolManager.engine_section) — written as engine.json so the
        # bundle shows per-engine occupancy/page pressure at anomaly time
        self.engine_fn = None
        # optional zero-arg callable returning the training health view
        # (TrainingHealthLedger.bundle_view) — written as training.json so
        # an entropy-collapse bundle carries the RL-dynamics tail and the
        # last batch's GRPO group table
        self.training_fn = None
        # optional zero-arg callable returning the recent per-step
        # critical paths (the trainer's CriticalPath.to_dict deque) —
        # written as critical_path.json so a stall bundle shows which
        # chain bounded the steps leading into the anomaly
        self.critical_path_fn = None
        # optional zero-arg callable returning the KV memory plane view
        # (PageLedger.snapshot via the engine/pool) — written as
        # memory.json so a cold-frac / headroom anomaly bundle carries the
        # page roles, tiers, free-cause churn and reconciliation state
        self.memory_fn = None
        # optional zero-arg callable returning the fleet engine-loop
        # profiler view (PoolManager.loop_profile_section) — written as
        # engine_profile.json so a device-frac/accounting-frac anomaly
        # bundle carries the per-engine device-vs-host split
        self.engine_profile_fn = None

    # -- step stream ---------------------------------------------------------

    def record_step(self, step: int, record: dict) -> str | None:
        """Feed one finished step's metric record; dumps and returns a
        bundle path when any watched series is anomalous."""
        with self._lock:
            self._steps.append({"step": step, **record})
        reasons = []
        for key, det in self._detectors.items():
            if key not in record:
                continue
            z = det.observe(float(record[key]))
            if z is not None:
                reasons.append(f"{key}={record[key]:.4g} z={z:.1f}")
        if not reasons:
            return None
        self.anomalies += 1
        return self.dump("anomaly", detail="; ".join(reasons), step=step)

    def counters(self) -> dict[str, float]:
        """Step-record gauges (``obs/*`` namespace, lint-documented)."""
        return {"obs/anomalies": float(self.anomalies),
                "obs/bundles": float(len(self.bundle_paths))}

    # -- bundle dump ---------------------------------------------------------

    def dump(self, reason: str, detail: str = "",
             step: int | None = None) -> str | None:
        """Write one post-mortem bundle; returns its path (None when the
        bundle budget is spent or the write fails — the recorder must
        never take the run down)."""
        with self._lock:
            if len(self.bundle_paths) >= self.max_bundles:
                self.bundles_dropped += 1
                log.warning("flight recorder: bundle budget (%d) spent; "
                            "dropping %r", self.max_bundles, reason)
                return None
            self._seq += 1
            seq = self._seq
            steps = list(self._steps)
        slug = re.sub(r"[^a-zA-Z0-9_.-]+", "_", reason)[:40]
        path = os.path.join(self.out_dir, "postmortem", f"{seq:03d}-{slug}")
        try:
            os.makedirs(path, exist_ok=True)
            from polyrl_tpu_torch.obs import get_tracer
            from polyrl_tpu_torch.obs.trace import clock_anchor

            tracer = get_tracer()
            with open(os.path.join(path, "spans.jsonl"), "w") as f:
                # leading monotonic↔wall anchor: the bundle's spans merge
                # skew-free with other processes' dumps (trace2perfetto)
                f.write(json.dumps(clock_anchor()) + "\n")
                for rec in tracer.records():
                    f.write(json.dumps(rec) + "\n")
            with open(os.path.join(path, "steps.jsonl"), "w") as f:
                for rec in steps:
                    f.write(json.dumps(rec) + "\n")
            with open(os.path.join(path, "stacks.txt"), "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            counters = {}
            if self.counters_fn is not None:
                try:
                    counters = dict(self.counters_fn())
                except Exception:  # noqa: BLE001 — counters are best-effort
                    log.exception("flight recorder counters_fn failed")
            if self.engine_fn is not None:
                try:
                    engine_view = dict(self.engine_fn())
                except Exception:  # noqa: BLE001 — best-effort like counters
                    log.exception("flight recorder engine_fn failed")
                    engine_view = {}
                if engine_view:
                    with open(os.path.join(path, "engine.json"), "w") as f:
                        json.dump(engine_view, f, indent=2)
            if self.training_fn is not None:
                try:
                    training_view = dict(self.training_fn())
                except Exception:  # noqa: BLE001 — best-effort like counters
                    log.exception("flight recorder training_fn failed")
                    training_view = {}
                if training_view:
                    with open(os.path.join(path, "training.json"), "w") as f:
                        json.dump(training_view, f, indent=2)
            if self.critical_path_fn is not None:
                try:
                    cp_view = dict(self.critical_path_fn())
                except Exception:  # noqa: BLE001 — best-effort like counters
                    log.exception("flight recorder critical_path_fn failed")
                    cp_view = {}
                if cp_view:
                    with open(os.path.join(path, "critical_path.json"),
                              "w") as f:
                        json.dump(cp_view, f, indent=2)
            if self.memory_fn is not None:
                try:
                    memory_view = dict(self.memory_fn())
                except Exception:  # noqa: BLE001 — best-effort like counters
                    log.exception("flight recorder memory_fn failed")
                    memory_view = {}
                if memory_view:
                    with open(os.path.join(path, "memory.json"), "w") as f:
                        json.dump(memory_view, f, indent=2)
            if self.engine_profile_fn is not None:
                try:
                    profile_view = dict(self.engine_profile_fn())
                except Exception:  # noqa: BLE001 — best-effort like counters
                    log.exception("flight recorder engine_profile_fn failed")
                    profile_view = {}
                if profile_view:
                    with open(os.path.join(path, "engine_profile.json"),
                              "w") as f:
                        json.dump(profile_view, f, indent=2)
            _write_memory_snapshot(path)
            with open(os.path.join(path, "counters.json"), "w") as f:
                json.dump({
                    "reason": reason,
                    "detail": detail,
                    "step": step,
                    "time_unix_s": time.time(),
                    "anomalies": self.anomalies,
                    "tracer_dropped_spans": tracer.dropped,
                    "fault_counters": counters,
                    "detectors": {k: d.state()
                                  for k, d in self._detectors.items()},
                }, f, indent=2)
        except Exception:  # noqa: BLE001 — a post-mortem writer that
            # crashes the run it is documenting is worse than no bundle
            log.exception("flight recorder bundle write failed (%s)", path)
            return None
        self.bundle_paths.append(path)
        log.warning("flight recorder: %s bundle -> %s (%s)",
                    reason, path, detail or "no detail")
        return path

    # -- signal wiring (main-thread only; train.py entry) --------------------

    def install_signal_handlers(self) -> None:
        """Dump a bundle on SIGTERM, then re-deliver the default action so
        the process still dies with the expected signal semantics. Call
        from the MAIN thread only (signal module constraint)."""

        def _on_term(signum, frame):  # noqa: ARG001
            self.dump("sigterm", detail=f"signal {signum}")
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
