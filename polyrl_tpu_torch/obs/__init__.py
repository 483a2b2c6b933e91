"""Observability: span tracing, histogram metrics, scraping and the planes
that read them (a copy of ``polyrl_tpu/obs``).

- :mod:`polyrl_tpu_torch.obs.trace` — ``Span``/``Tracer`` with
  thread-local context, a bounded ring buffer and Chrome-trace export.
  Cross-process propagation rides the ``X-Trace-Id``/``X-Span-Id`` HTTP
  headers (ManagerClient → C++ manager → rollout server), which the
  manager echoes into the requests it forwards.
- :mod:`polyrl_tpu_torch.obs.histogram` — the fixed-bucket log2
  ``Histogram`` and the process-global registry that ``observe()`` feeds
  and the trainer drains into each step record.
- :mod:`polyrl_tpu_torch.obs.scrape` — Prometheus text parsing of the
  manager's ``GET /metrics`` into ``manager/*`` gauges.
- :mod:`polyrl_tpu_torch.obs.goodput` — each step's wall split into
  non-overlapping ``goodput/*`` phases, tokens per second, MFU.
- :mod:`polyrl_tpu_torch.obs.rlhealth` — the training health ledger
  (``training/*``: advantage, TIS and staleness distributions, GRPO
  group diagnostics).
- :mod:`polyrl_tpu_torch.obs.critical_path` — which chain of spans
  bounded each step (``critpath/*``).
- :mod:`polyrl_tpu_torch.obs.recorder` — the anomaly flight recorder and
  its post-mortem bundles.
- :mod:`polyrl_tpu_torch.obs.statusz` — the ``/statusz`` schema both the
  trainer and the rollout server serve, and its Prometheus rendering.
- :mod:`polyrl_tpu_torch.obs.timeseries` — bounded per-key rings with
  windowed aggregates and slopes (``/statusz`` ``timeseries``, the pool's
  balance trends).
- :mod:`polyrl_tpu_torch.obs.engine_profile` — the CB engine's loop
  profiler (``/statusz`` ``engine.loop``).

Everything here is stdlib and numpy only and costs almost nothing while
tracing is off.
"""

from __future__ import annotations

import contextlib

from polyrl_tpu_torch.obs.critical_path import (SEGMENTS,  # noqa: F401
                                                CriticalPath,
                                                extract_critical_path)
from polyrl_tpu_torch.obs.goodput import GoodputLedger  # noqa: F401
from polyrl_tpu_torch.obs.histogram import (Histogram,  # noqa: F401
                                            drain_histograms, drain_registry,
                                            observe)
from polyrl_tpu_torch.obs.recorder import (AnomalyDetector,  # noqa: F401
                                           FlightRecorder, direction_violates)
from polyrl_tpu_torch.obs.rlhealth import TrainingHealthLedger  # noqa: F401
from polyrl_tpu_torch.obs.scrape import (manager_gauges,  # noqa: F401
                                         manager_gauges_partial,
                                         parse_prometheus_text,
                                         parse_prometheus_text_partial)
from polyrl_tpu_torch.obs.statusz import (StatuszServer,  # noqa: F401
                                          build_snapshot)
from polyrl_tpu_torch.obs.timeseries import (TimeSeriesStore,  # noqa: F401
                                             least_squares_slope)
from polyrl_tpu_torch.obs.trace import Tracer, get_tracer  # noqa: F401

_jax_annotations = False


def configure(trace: bool | None = None, max_spans: int | None = None,
              out_dir: str | None = None,
              jax_annotations: bool | None = None,
              reset: bool = False) -> Tracer:
    """Configure the process-global tracer and the phase-annotation
    toggle (``obs.jax_annotations``, the reference's key: here
    ``torch.profiler.record_function`` ranges). ``None`` leaves a setting
    unchanged; ``reset`` clears the span ring buffer and the histogram
    registry."""
    global _jax_annotations
    tracer = get_tracer()
    if trace is not None:
        tracer.enabled = trace
    if max_spans is not None:
        tracer.set_capacity(max_spans)
    if out_dir is not None:
        tracer.out_dir = out_dir or None
    if jax_annotations is not None:
        _jax_annotations = jax_annotations
    if reset:
        tracer.clear()
        drain_histograms()
    return tracer


def span(name: str, **attrs):
    """Open a span on the global tracer (no-op when tracing is disabled)."""
    return get_tracer().span(name, **attrs)


def trace_headers() -> dict[str, str]:
    """HTTP headers carrying the current trace context ({} when none)."""
    return get_tracer().headers()


def phase_annotation(name: str):
    """A ``torch.profiler.record_function`` range named for the trainer
    phase, so that a ``trainer.profile_steps`` trace lines up with the host
    spans (``configure(jax_annotations=True)``); a null context
    otherwise."""
    if not _jax_annotations:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function("trainer/" + name)
