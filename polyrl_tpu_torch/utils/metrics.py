"""Metrics tracking, phase timers and logging backends.

Counterpart of ``polyrl_tpu/utils/metrics.py``: ``MetricsTracker``
(repeated keys average (losses), timing keys sum (a phase can run many
times per step), gauges take the last value, counters sum raw, histograms
summarise to percentiles), ``marked_timer`` (a phase's timing, a tracer
span ``trainer/<phase>`` and, with ``obs.jax_annotations``, a
``torch.profiler`` range) and the ``Tracking`` logger over console, JSONL,
TensorBoard and W&B. Metric names are ``area/name``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
import warnings
from collections import defaultdict
from typing import Any

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.obs.histogram import Histogram

log = logging.getLogger(__name__)

_collision_warned: set[str] = set()


def _strict_metrics() -> bool:
    # collisions raise under pytest, warn once at runtime
    return "PYTEST_CURRENT_TEST" in os.environ


class MetricsTracker:
    """Accumulates the metrics of one step."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)
        self._timings = defaultdict(float)
        # name -> [(t0, t1)] on the monotonic clock, for timings given a start
        self._spans = defaultdict(list)
        self._gauges: dict[str, float] = {}
        self._counters = defaultdict(float)
        self._hists: dict[str, Histogram] = {}

    def update(self, metrics: dict[str, Any]) -> None:
        for k, v in metrics.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def update_gauge(self, metrics: dict[str, Any]) -> None:
        """Last-value-wins metrics (cumulative counters)."""
        for k, v in metrics.items():
            self._gauges[k] = float(v)

    def incr(self, name: str, amount: float = 1.0) -> None:
        """Within-step counter emitted raw (not averaged)."""
        self._counters[name] += amount

    def add_timing(self, name: str, seconds: float,
                   t0: float | None = None) -> None:
        """``t0`` (``time.monotonic()`` at the start) also keeps the
        interval, for ``spans``."""
        self._timings[name] += seconds
        if t0 is not None:
            self._spans[name].append((t0, t0 + seconds))

    def observe(self, name: str, value: float) -> None:
        """Distribution sample; ``as_dict`` emits ``<name>/{p50,p95,p99,max,
        mean,count}``."""
        hist = self._hists.get(name)
        if hist is None:
            hist = self._hists[name] = Histogram()
        hist.observe(value)

    def timings(self) -> dict[str, float]:
        return dict(self._timings)

    def spans(self, name: str) -> list[tuple[float, float]]:
        """The intervals of the ``name`` timings given a start."""
        return list(self._spans.get(name, ()))

    def get(self, key: str, default: float = 0.0) -> float:
        """Current value of one metric by key (averaged, gauge, counter)."""
        if key in self._sums:
            return self._sums[key] / self._counts[key]
        if key in self._gauges:
            return self._gauges[key]
        if key in self._counters:
            return self._counters[key]
        return default

    def merge(self, other: "MetricsTracker") -> None:
        for k, v in other._sums.items():
            self._sums[k] += v
            self._counts[k] += other._counts[k]
        for k, v in other._timings.items():
            self._timings[k] += v
        for k, v in other._spans.items():
            self._spans[k].extend(v)
        self._gauges.update(other._gauges)
        for k, v in other._counters.items():
            self._counters[k] += v
        self.merge_histograms(other._hists)

    def merge_histograms(self, hists: dict[str, Histogram]) -> None:
        for name, h in hists.items():
            mine = self._hists.get(name)
            if mine is None:
                self._hists[name] = h
            else:
                mine.merge(h)

    def as_dict(self) -> dict[str, float]:
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        groups = {
            "timing": {f"timing_s/{k}": v for k, v in self._timings.items()},
            "counter": dict(self._counters),
            "histogram": {k: v for h_name, h in self._hists.items()
                          for k, v in h.summary(h_name).items()},
            "gauge": self._gauges,
        }
        for kind, metrics in groups.items():
            for k, v in metrics.items():
                if k in out:
                    self._collide(kind, k)
                out[k] = v
        return out

    @staticmethod
    def _collide(kind: str, key: str) -> None:
        msg = (f"metric key collision: {kind} metric {key!r} overwrites an "
               f"earlier metric in the same step record")
        if _strict_metrics():
            raise ValueError(msg)
        if key not in _collision_warned:
            _collision_warned.add(key)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def marked_timer(name: str, tracker: MetricsTracker):
    """Phase timer: always emits ``timing_s/<name>``, even when the phase
    raises (a failure also counts ``<name>/failed``); opens the tracer
    span ``trainer/<name>`` and, when enabled, a profiler range."""
    t0 = time.monotonic()
    with obs.span("trainer/" + name), obs.phase_annotation(name):
        try:
            yield
        except BaseException:
            tracker.incr(f"{name}/failed")
            raise
        finally:
            tracker.add_timing(name, time.monotonic() - t0, t0=t0)


class Tracking:
    """Console/JSONL/TensorBoard/W&B logger (the reference's ``Tracking``).
    Each backend logs inside its own guard: a backend whose package is
    absent, or whose call fails (a full disk, a dead socket), is logged
    once per failure and counted in ``log_errors`` (the trainer's
    ``obs/log_errors`` gauge); it never aborts a step and never drops
    records unseen."""

    KEYS = ("perf/step_time_s", "reward/mean", "actor/pg_loss",
            "critic/vf_loss", "val/test_score/mean",
            "goodput/attributed_frac", "training/resumed_from_step")

    def __init__(self, backends: tuple[str, ...] = ("console",),
                 path: str | None = None, project: str = "polyrl_tpu_torch",
                 run_name: str | None = None, config: dict | None = None):
        self.backends = tuple(backends)
        self.log_errors = 0
        self._file = None
        self._tb = None
        self._wandb = None
        if path and "jsonl" in self.backends:
            if os.path.dirname(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
            self._file = open(path, "a")
        if "tensorboard" in self.backends:
            def _open_tb():
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(path or "runs")
            self._guard("tensorboard", _open_tb)
        if "wandb" in self.backends:
            def _open_wandb():
                import wandb

                self._wandb = wandb.init(project=project, name=run_name,
                                         config=config or {})
            self._guard("wandb", _open_wandb)

    def _guard(self, backend: str, fn) -> None:
        try:
            fn()
        except Exception:  # noqa: BLE001 — a logger must never kill a step
            self.log_errors += 1
            log.exception("%s logging backend failed (drop %d)",
                          backend, self.log_errors)

    def log(self, metrics: dict, step: int) -> None:
        if "console" in self.backends:
            def _console():
                brief = {k: round(metrics[k], 4) for k in self.KEYS
                         if k in metrics}
                print(f"[step {step}] {brief}", flush=True)
            self._guard("console", _console)
        if self._file is not None:
            def _jsonl():
                self._file.write(json.dumps({"step": step, **metrics}) + "\n")
                self._file.flush()
            self._guard("jsonl", _jsonl)
        if self._tb is not None:
            def _tb():
                for k, v in metrics.items():
                    self._tb.add_scalar(k, v, step)
            self._guard("tensorboard", _tb)
        if self._wandb is not None:
            self._guard("wandb",
                        lambda: self._wandb.log(metrics, step=step))

    def close(self) -> None:
        if self._file is not None:
            self._guard("jsonl", self._file.close)
        if self._tb is not None:
            self._guard("tensorboard", self._tb.close)
        if self._wandb is not None:
            self._guard("wandb", self._wandb.finish)
