"""Observability: span tracing, histogram metrics and scraping, the part
that the disaggregated rollout path calls.

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
- :mod:`polyrl_tpu_torch.obs.timeseries` — bounded per-key rings with
  windowed aggregates and slopes (the pool's balance trends).

The observability planes that read these (goodput, the training health
ledger, the flight recorder, ``/statusz``, the critical path and the
engine-loop profiler) are not ported yet (ROADMAP A' 6). Everything here
is stdlib only and costs almost nothing while tracing is off.
"""

from __future__ import annotations

from polyrl_tpu_torch.obs.histogram import (Histogram,  # noqa: F401
                                            drain_histograms, observe)
from polyrl_tpu_torch.obs.scrape import (manager_gauges,  # noqa: F401
                                         manager_gauges_partial,
                                         parse_prometheus_text,
                                         parse_prometheus_text_partial)
from polyrl_tpu_torch.obs.timeseries import (TimeSeriesStore,  # noqa: F401
                                             least_squares_slope)
from polyrl_tpu_torch.obs.trace import Tracer, get_tracer  # noqa: F401


def configure(trace: bool | None = None, max_spans: int | None = None,
              out_dir: str | None = None, reset: bool = False) -> Tracer:
    """Configure the process-global tracer. ``None`` leaves a setting
    unchanged; ``reset`` clears the span ring buffer and the histogram
    registry."""
    tracer = get_tracer()
    if trace is not None:
        tracer.enabled = trace
    if max_spans is not None:
        tracer.set_capacity(max_spans)
    if out_dir is not None:
        tracer.out_dir = out_dir or None
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
