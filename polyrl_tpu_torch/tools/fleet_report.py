"""Fleet timeline + per-step critical-path report from a run's records.

Reads a ``steps.jsonl`` (the Tracking jsonl log, a run dir containing
one, or a flight-recorder post-mortem bundle dir — which also yields
``counters.json`` / ``critical_path.json`` context) and renders the
critical-path plane (ARCHITECTURE.md "Critical-path plane") as text:

- a per-step timeline: one bar per step, its cells split by the step's
  critical-path segment fractions (``critpath/*_frac``; falls back to
  the ``goodput/*`` phase walls for untraced runs), annotated with the
  wall time and the bottleneck segment;
- a trend table over the same window: windowed aggregates
  (last/mean/p95/min/max + least-squares slope, obs/timeseries.py) for
  the autoscaling-relevant series — step wall, bottleneck fraction,
  headroom, occupancy, the fleet engine-loop device/accounting split,
  trainer bubble;
- when pointed at a bundle: the bundle's reason/detail and the recorded
  critical paths (``critical_path.json`` — the segment chain of the last
  traced steps, longest segments first).

Usage::

    python -m polyrl_tpu_torch.tools.fleet_report runs/steps.jsonl
    python -m polyrl_tpu_torch.tools.fleet_report runs/postmortem/001-anomaly/
    python -m polyrl_tpu_torch.tools.fleet_report steps.jsonl --last 32 --width 40

A copy of ``tools/fleet_report.py`` over the port's own observability modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from polyrl_tpu_torch.obs.critical_path import SEGMENTS
from polyrl_tpu_torch.obs.timeseries import aggregate

# one timeline cell letter per segment (SEGMENTS order)
_SEGMENT_CELL = {"generate": "G", "process": "P", "update": "U",
                 "push": "W", "bubble": ".", "manager": "M",
                 "housekeeping": "H", "other": "-"}

# goodput phase -> segment fallback for untraced runs (no critpath/*)
_GOODPUT_SEGMENT = (
    ("goodput/generate_s", "generate"),
    ("goodput/process_s", "process"),
    ("goodput/update_s", "update"),
    ("goodput/weight_push_s", "push"),
    ("goodput/bubble_s", "bubble"),
    ("goodput/manager_rtt_s", "manager"),
    ("goodput/housekeeping_s", "housekeeping"),
    ("goodput/other_s", "other"),
)

# (label, step-record key) — the trend table + slope surface
SERIES = (
    ("step_wall_s", "goodput/step_wall_s"),
    ("bottleneck_frac", "critpath/bottleneck_frac"),
    ("headroom_s", "critpath/headroom_s"),
    ("slack_s", "critpath/slack_s"),
    ("generate_frac", "critpath/generate_frac"),
    ("update_frac", "critpath/update_frac"),
    ("occupancy", "engine/occupancy"),
    ("occupancy_slope", "pool/balance_occupancy_slope"),
    # engine-loop profiler fleet gauges (obs/engine_profile.py): the
    # worst engine's device-vs-host split next to the occupancy rail —
    # busy-but-host-bound fleets show high occupancy with low device_frac
    ("device_frac", "engine/device_frac"),
    ("accounting_frac", "engine/accounting_frac"),
    ("trainer_bubble_s", "perf/trainer_bubble_s"),
    ("throughput_tok_s", "perf/throughput_tokens_per_s"),
)


def load_records(path: str) -> tuple[list[dict], dict]:
    """``(step records, bundle context)``: accepts a jsonl file, a run dir
    containing ``steps.jsonl``, or a post-mortem bundle dir (which also
    yields counters.json / critical_path.json context)."""
    ctx: dict = {}
    if os.path.isdir(path):
        for name in ("counters.json", "critical_path.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        ctx[name] = json.load(f)
                except ValueError:
                    pass
        path = os.path.join(path, "steps.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no step records at {path}")
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records, ctx


def _fmt(v: float | None) -> str:
    if v is None:
        return "-"
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.001:
        return f"{v:.3g}"
    return f"{v:.4f}".rstrip("0").rstrip(".")


def _step_fractions(rec: dict) -> dict[str, float] | None:
    """Per-segment fraction of the step wall, preferring the traced
    critical path over the goodput phase fallback."""
    fracs = {seg: float(rec[f"critpath/{seg}_frac"])
             for seg in SEGMENTS if f"critpath/{seg}_frac" in rec}
    if fracs:
        return fracs
    wall = float(rec.get("goodput/step_wall_s", 0.0))
    if wall <= 0:
        return None
    return {seg: float(rec.get(key, 0.0)) / wall
            for key, seg in _GOODPUT_SEGMENT}


def _bar(fracs: dict[str, float], width: int) -> str:
    """Largest-remainder fill so every visible segment gets >= its share
    of cells and the bar is always exactly ``width`` wide."""
    shares = [(seg, max(fracs.get(seg, 0.0), 0.0) * width)
              for seg in SEGMENTS]
    cells = {seg: int(share) for seg, share in shares}
    rest = sorted(((share - cells[seg], seg) for seg, share in shares),
                  reverse=True)
    for _, seg in rest[:max(width - sum(cells.values()), 0)]:
        cells[seg] += 1
    return "".join(_SEGMENT_CELL[seg] * cells[seg] for seg in SEGMENTS)


def timeline(records: list[dict], width: int) -> list[str]:
    legend = " ".join(f"{_SEGMENT_CELL[s]}={s}" for s in SEGMENTS)
    lines = [f"timeline ({legend}):"]
    for rec in records:
        fracs = _step_fractions(rec)
        if fracs is None:
            continue
        step = rec.get("training/global_step", rec.get("step", "?"))
        wall = rec.get("goodput/step_wall_s")
        bi = rec.get("critpath/bottleneck")
        bottleneck = (SEGMENTS[int(bi)] if bi is not None
                      and 0 <= int(bi) < len(SEGMENTS)
                      else max(fracs, key=fracs.get))
        head = rec.get("critpath/headroom_s")
        note = f"  headroom {_fmt(float(head))}s" if head is not None else ""
        lines.append(f"  step {int(step) if step != '?' else '?':>4} "
                     f"{_fmt(float(wall) if wall is not None else None):>8}s "
                     f"|{_bar(fracs, width)}| {bottleneck}{note}")
    if len(lines) == 1:
        lines.append("  no goodput/critpath data in these records")
    return lines


def trend_table(records: list[dict]) -> list[str]:
    lines = [f"{'series':<18} {'last':>9} {'mean':>9} {'p95':>9} "
             f"{'min':>9} {'max':>9} {'slope/step':>11}"]
    for label, key in SERIES:
        pts = [(float(r.get("training/global_step", i)), float(r[key]))
               for i, r in enumerate(records) if key in r]
        if not pts:
            continue
        agg = aggregate(pts)
        lines.append(
            f"{label:<18} {_fmt(agg['last']):>9} {_fmt(agg['mean']):>9} "
            f"{_fmt(agg['p95']):>9} {_fmt(agg['min']):>9} "
            f"{_fmt(agg['max']):>9} {_fmt(agg['slope']):>11}")
    return lines


def path_table(bundle_paths: dict, max_paths: int = 4,
               max_segs: int = 8) -> list[str]:
    paths = bundle_paths.get("paths") or []
    lines: list[str] = []
    for cp in paths[-max_paths:]:
        merged: dict[str, float] = {}
        for seg, dur in cp.get("path", []):
            merged[seg] = merged.get(seg, 0.0) + float(dur)
        chain = " > ".join(
            f"{seg} {_fmt(dur)}s" for seg, dur in
            sorted(merged.items(), key=lambda kv: -kv[1])[:max_segs])
        lines.append(f"step {cp.get('step', '?')}: wall "
                     f"{_fmt(cp.get('wall_s'))}s bottleneck "
                     f"{cp.get('bottleneck', '?')} (headroom "
                     f"{_fmt(cp.get('headroom_s'))}s) — {chain}")
        for rem in (cp.get("remote") or [])[:2]:
            lines.append(f"    remote: {rem.get('name', '?')} "
                         f"{_fmt(rem.get('dur_s'))}s (pid {rem.get('pid')})")
    return lines


def render(records: list[dict], ctx: dict, *, last: int,
           width: int) -> str:
    out: list[str] = []
    window = records[-last:] if last > 0 else records
    steps = [r.get("training/global_step", r.get("step")) for r in window]
    steps = [s for s in steps if s is not None]
    span = (f"steps {int(min(steps))}–{int(max(steps))}" if steps
            else f"{len(window)} records")
    out.append(f"fleet report — {len(window)} records ({span})")
    out.append("")
    if "counters.json" in ctx:
        c = ctx["counters.json"]
        out.append(f"bundle: {c.get('reason', '?')} at step "
                   f"{c.get('step', '?')} — {c.get('detail', '')}")
        out.append("")
    out.extend(timeline(window, width))
    out.append("")
    table = trend_table(window)
    if len(table) > 1:
        out.extend(table)
    else:
        out.append("no watched series in these records")
    cp = ctx.get("critical_path.json")
    if cp:
        out.append("")
        out.append("recorded critical paths (critical_path.json):")
        out.extend("  " + p for p in path_table(cp))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render steps.jsonl (or a postmortem bundle) into a "
                    "per-step critical-path timeline + fleet trend table")
    ap.add_argument("path", help="steps.jsonl, a dir containing it, or a "
                                 "postmortem bundle dir")
    ap.add_argument("--last", type=int, default=32,
                    help="window: last N records (default 32; 0 = all)")
    ap.add_argument("--width", type=int, default=32,
                    help="timeline bar width in cells (default 32)")
    args = ap.parse_args(argv)
    try:
        records, ctx = load_records(args.path)
    except (OSError, FileNotFoundError) as exc:
        print(f"fleet_report: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"fleet_report: no parseable step records in {args.path}",
              file=sys.stderr)
        return 2
    print(render(records, ctx, last=args.last, width=args.width))
    return 0


if __name__ == "__main__":
    sys.exit(main())
