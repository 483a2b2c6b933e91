"""Prometheus text-exposition parsing for the manager /metrics scrape (a
copy of ``polyrl_tpu/obs/scrape.py``).

The C++ manager (and the rollout servers) already expose Prometheus text;
the trainer scrapes the manager once per step and merges the unlabeled
series into the step record as ``manager/*`` gauges — pool health, queue
depths, and per-route request totals become greppable next to the
training metrics instead of needing a separate Prometheus deployment.

Parse telemetry rides the ``obs/*`` self-telemetry namespace: lines that
LOOK like samples but fail to parse (truncated response mid-line, a NaN
an exporter leaked, a value torn by a non-atomic writer) are COUNTED, not
silently dropped — ``RemoteRollout`` accumulates them behind the
``obs/scrape_partial`` step counter, and each scrape's wall latency lands
in the ``manager/scrape_s`` histogram.
"""

from __future__ import annotations


def parse_prometheus_text_partial(text: str) -> tuple[dict[str, float], int]:
    """Unlabeled ``name value`` series → ``({name: value}, partials)``.

    ``partials`` counts sample-looking lines that failed to parse — a
    missing or malformed value. Labeled series (``name{...}``) are NOT
    partial: they are per-instance breakdowns whose label values (raw
    endpoints) don't fit the flat ``area/name`` step-record namespace —
    they stay on the /metrics surface for real scrapers.
    """
    out: dict[str, float] = {}
    partials = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.partition(" ")
        if not name or "{" in name:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            partials += 1
            continue
    return out, partials


def parse_prometheus_text(text: str) -> dict[str, float]:
    """:func:`parse_prometheus_text_partial` keeping only the series."""
    return parse_prometheus_text_partial(text)[0]


def manager_gauges_partial(text: str, strip: str = "polyrl_mgr_",
                           prefix: str = "manager/"
                           ) -> tuple[dict[str, float], int]:
    """Scraped manager metrics → (step-record gauge keys, partial-line
    count): ``polyrl_mgr_running_reqs`` → ``manager/running_reqs``."""
    out = {}
    series, partials = parse_prometheus_text_partial(text)
    for name, value in series.items():
        if name.startswith(strip):
            name = name[len(strip):]
        out[prefix + name] = value
    return out, partials


def manager_gauges(text: str, strip: str = "polyrl_mgr_",
                   prefix: str = "manager/") -> dict[str, float]:
    """:func:`manager_gauges_partial` keeping only the gauges."""
    return manager_gauges_partial(text, strip=strip, prefix=prefix)[0]
