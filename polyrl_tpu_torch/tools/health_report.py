"""One-page training-health summary from a run's step records.

Reads a ``steps.jsonl`` (the Tracking jsonl log, or a flight-recorder
post-mortem bundle directory — anything whose lines are per-step metric
records) and renders the training health plane (ARCHITECTURE.md
"Training health plane") as text:

- a trend table for the watched RL-dynamics series — entropy, approx KL,
  grad norm, degenerate-group fraction, effective-batch fraction,
  per-token weight-version staleness (p95 + max), TIS clip fraction,
  reward mean — first/median/last/min/max over the window;
- flagged anomalies: the same direction-aware EWMA/z-score detector the
  live FlightRecorder runs (obs/recorder.py), replayed over
  the records, so an offline reader sees exactly what the recorder
  would have fired on;
- when pointed at a post-mortem bundle: the bundle's reason/detail
  (counters.json) and the last batch's GRPO group table (training.json).

Usage::

    python -m polyrl_tpu_torch.tools.health_report runs/steps.jsonl
    python -m polyrl_tpu_torch.tools.health_report runs/postmortem/001-anomaly/
    python -m polyrl_tpu_torch.tools.health_report steps.jsonl --last 32 --z 4.0

A copy of ``tools/health_report.py`` over the port's own observability modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from polyrl_tpu_torch.obs.recorder import AnomalyDetector

# (label, step-record key, direction-that-is-bad) — directions match the
# FlightRecorder DEFAULT_WATCH + the bench_gate watch list
SERIES = (
    ("entropy", "training/entropy", "low"),
    ("approx_kl", "training/approx_kl", "high"),
    ("grad_norm", "training/grad_norm", "high"),
    ("degenerate_groups", "training/degenerate_group_frac", "high"),
    ("effective_batch", "training/effective_batch_frac", "low"),
    ("staleness_p95", "training/staleness/p95", "high"),
    ("staleness_max", "training/staleness_max", "high"),
    ("tis_clip_frac", "training/tis_clip_frac", "high"),
    ("reward_mean", "reward/mean", "both"),
    ("step_time_s", "perf/step_time_s", "high"),
)


def load_records(path: str) -> tuple[list[dict], dict]:
    """``(step records, bundle context)``: accepts a jsonl file, a run dir
    containing ``steps.jsonl``, or a post-mortem bundle dir (which also
    yields counters.json / training.json context)."""
    ctx: dict = {}
    if os.path.isdir(path):
        for name in ("counters.json", "training.json"):
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


def _median(vals: list[float]) -> float:
    srt = sorted(vals)
    mid = len(srt) // 2
    return srt[mid] if len(srt) % 2 else 0.5 * (srt[mid - 1] + srt[mid])


def _fmt(v: float | None) -> str:
    if v is None:
        return "-"
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.001:
        return f"{v:.3g}"
    return f"{v:.4f}".rstrip("0").rstrip(".")


def trend_table(records: list[dict]) -> list[str]:
    lines = [f"{'series':<20} {'first':>9} {'median':>9} {'last':>9} "
             f"{'min':>9} {'max':>9}  trend"]
    for label, key, direction in SERIES:
        vals = [float(r[key]) for r in records if key in r]
        if not vals:
            continue
        delta = vals[-1] - vals[0]
        arrow = "·" if abs(delta) < 1e-12 else ("↑" if delta > 0 else "↓")
        note = ""
        if direction == "low" and vals[-1] < min(vals[0], _median(vals)):
            note = " (watch: collapsing)"
        elif direction == "high" and vals[-1] > max(vals[0], _median(vals)):
            note = " (watch: rising)"
        lines.append(
            f"{label:<20} {_fmt(vals[0]):>9} {_fmt(_median(vals)):>9} "
            f"{_fmt(vals[-1]):>9} {_fmt(min(vals)):>9} {_fmt(max(vals)):>9}"
            f"  {arrow}{note}")
    return lines


def replay_anomalies(records: list[dict], z: float, warmup: int
                     ) -> list[str]:
    """Replay the direction-aware detector over each watched series;
    returns human lines for every firing."""
    flagged: list[str] = []
    for label, key, direction in SERIES:
        det = AnomalyDetector(z_threshold=z, warmup=warmup,
                              direction=direction)
        for rec in records:
            if key not in rec:
                continue
            zscore = det.observe(float(rec[key]))
            if zscore is not None:
                step = rec.get("step", rec.get("training/global_step", "?"))
                flagged.append(
                    f"step {step}: {label} = {_fmt(float(rec[key]))} "
                    f"(z={zscore:+.1f}, watching '{direction}')")
    return flagged


def group_table(training: dict, max_rows: int = 16) -> list[str]:
    rows = training.get("last_groups") or []
    if not rows:
        return []
    lines = [f"{'group':>5} {'size':>4} {'r_mean':>8} {'r_std':>8} "
             f"{'degen':>5} {'len':>6} {'trunc':>5} {'stale':>5}  source"]
    for row in rows[:max_rows]:
        lines.append(
            f"{row.get('group', '?'):>5} {row.get('size', '?'):>4} "
            f"{_fmt(row.get('reward_mean')):>8} "
            f"{_fmt(row.get('reward_std')):>8} "
            f"{str(bool(row.get('degenerate'))):>5} "
            f"{_fmt(row.get('len_mean')):>6} {row.get('truncated', 0):>5} "
            f"{row.get('staleness_max', '-'):>5}  "
            f"{row.get('data_source', '')}")
    if len(rows) > max_rows:
        lines.append(f"... {len(rows) - max_rows} more groups")
    return lines


def render(records: list[dict], ctx: dict, *, last: int, z: float,
           warmup: int) -> str:
    out: list[str] = []
    window = records[-last:] if last > 0 else records
    steps = [r.get("step", r.get("training/global_step")) for r in window]
    steps = [s for s in steps if s is not None]
    span = (f"steps {int(min(steps))}–{int(max(steps))}" if steps
            else f"{len(window)} records")
    out.append(f"training health report — {len(window)} records ({span})")
    out.append("")
    if "counters.json" in ctx:
        c = ctx["counters.json"]
        out.append(f"bundle: {c.get('reason', '?')} at step "
                   f"{c.get('step', '?')} — {c.get('detail', '')}")
        out.append("")
    table = trend_table(window)
    if len(table) > 1:
        out.extend(table)
    else:
        out.append("no training/* series in these records — is the health "
                   "ledger enabled? (obs.rlhealth, default on)")
    out.append("")
    flagged = replay_anomalies(window, z, warmup)
    if flagged:
        out.append(f"anomalies ({len(flagged)} flagged, z>{z:g} in the "
                   "watched direction):")
        out.extend("  " + f for f in flagged)
    else:
        out.append(f"no anomalies (z>{z:g} in the watched directions)")
    training = ctx.get("training.json")
    if training:
        out.append("")
        out.append("last batch's GRPO group table (training.json):")
        out.extend("  " + g for g in group_table(training))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render steps.jsonl (or a postmortem bundle) into a "
                    "one-page training-health summary")
    ap.add_argument("path", help="steps.jsonl, a dir containing it, or a "
                                 "postmortem bundle dir")
    ap.add_argument("--last", type=int, default=64,
                    help="window: last N records (default 64; 0 = all)")
    ap.add_argument("--z", type=float, default=4.0,
                    help="anomaly z-score threshold (default 4.0)")
    ap.add_argument("--warmup", type=int, default=5,
                    help="detector warmup steps (default 5)")
    args = ap.parse_args(argv)
    try:
        records, ctx = load_records(args.path)
    except (OSError, FileNotFoundError) as exc:
        print(f"health_report: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"health_report: no parseable step records in {args.path}",
              file=sys.stderr)
        return 2
    print(render(records, ctx, last=args.last, z=args.z,
                 warmup=args.warmup))
    return 0


if __name__ == "__main__":
    sys.exit(main())
