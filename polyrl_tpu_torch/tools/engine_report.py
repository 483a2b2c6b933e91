"""One-page engine-loop profiler report (ARCHITECTURE.md "Engine-loop
profiler").

Renders the ``engine.loop`` statusz block — the CB engine's exhaustive
per-iteration phase attribution (obs/engine_profile.py): the phase-bar
timeline of where the loop wall went, per-phase latency summaries, the
windowed device-vs-host split and the ``attributed_frac`` partition pin —
as text, from any of:

- a live plane: ``host:port`` or ``http://host:port`` (GET /statusz;
  works on both roles — the rollout plane serves its engine's own
  profile, the trainer the fleet view from PoolManager sweeps);
- a flight-recorder post-mortem bundle dir (reads its
  ``engine_profile.json`` plus the bundle reason from ``counters.json``);
- a JSON file: a saved ``engine_profile.json``, a single-engine ``loop``
  snapshot, or a whole statusz snapshot.

Usage::

    python -m polyrl_tpu_torch.tools.engine_report 127.0.0.1:30000
    python -m polyrl_tpu_torch.tools.engine_report runs/postmortem/001-anomaly/
    python -m polyrl_tpu_torch.tools.engine_report engine_profile.json

A copy of ``tools/engine_report.py`` over the port's own observability modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

_HIST_COLS = ("p50", "p95", "p99", "max", "mean", "count")
_BAR_WIDTH = 60
# phase → bar glyph, in display order (matches engine_profile.PHASES)
_PHASE_GLYPHS = (
    ("collect_wave", "c"),
    ("restore", "r"),
    ("prefill_dispatch", "P"),
    ("decode_dispatch_device", "D"),
    ("sample_fetch", "F"),
    ("emit", "e"),
    ("accounting", "a"),
    ("spill_sweep", "s"),
    ("idle", "."),
    ("other", "?"),
)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 0.001:
            return f"{v:.3g}"
        return f"{v:.4f}".rstrip("0").rstrip(".")
    return str(v)


def load(target: str) -> tuple[dict, dict]:
    """``(loop section, context)`` from a URL, bundle dir, or JSON file.
    A full statusz snapshot yields its ``engine.loop`` key; context
    carries the source + the bundle's counters.json when present."""
    ctx: dict = {"source": target}
    if os.path.isdir(target):
        cpath = os.path.join(target, "counters.json")
        if os.path.exists(cpath):
            try:
                with open(cpath) as f:
                    ctx["counters"] = json.load(f)
            except ValueError:
                pass
        target = os.path.join(target, "engine_profile.json")
    if os.path.exists(target):
        with open(target) as f:
            doc = json.load(f)
    else:
        url = target if "://" in target else f"http://{target}"
        if not url.rstrip("/").endswith("/statusz"):
            url = url.rstrip("/") + "/statusz"
        with urllib.request.urlopen(url, timeout=10) as resp:
            doc = json.load(resp)
        ctx["source"] = url
    if not isinstance(doc, dict):
        raise ValueError(f"{target}: expected a JSON object")
    if "schema" in doc and "engine" in doc:
        ctx["role"] = doc.get("role", "?")
        ctx["schema"] = doc.get("schema", "?")
        doc = (doc["engine"] or {}).get("loop") or {}
    return doc, ctx


def _phase_bar(phase_frac: dict) -> str:
    """One ``_BAR_WIDTH``-column bar: each phase's glyph repeated in
    proportion to its share of the loop wall (largest-remainder fill so
    the bar is always exactly full)."""
    shares = [(name, glyph, float(phase_frac.get(name, 0.0)))
              for name, glyph in _PHASE_GLYPHS]
    total = sum(s[2] for s in shares) or 1.0
    cells = [(name, glyph, frac / total * _BAR_WIDTH)
             for name, glyph, frac in shares]
    counts = {name: int(w) for name, _g, w in cells}
    rem = _BAR_WIDTH - sum(counts.values())
    for name, _g, w in sorted(cells, key=lambda c: -(c[2] % 1.0)):
        if rem <= 0:
            break
        counts[name] += 1
        rem -= 1
    return "".join(glyph * counts[name] for name, glyph, _w in cells)


def _render_engine(loop: dict) -> list[str]:
    """Single-engine loop snapshot (the rollout plane's block)."""
    out: list[str] = []
    frac = loop.get("attributed_frac")
    flag = ""
    if isinstance(frac, (int, float)):
        if frac > 1.0:
            flag = "  <-- > 1.0: double-counted attribution"
        elif frac < 0.95:
            flag = "  <-- wall leaking out of the phase taxonomy"
    out.append(f"{loop.get('iters', 0)} loop iterations over "
               f"{_fmt(loop.get('wall_s'))} s wall; attributed_frac = "
               f"{_fmt(frac)}{flag}")
    phase_frac = loop.get("phase_frac", {})
    if phase_frac:
        out.append("")
        out.append(f"phase bar  [{_phase_bar(phase_frac)}]")
        legend = "  ".join(f"{g}={n}" for n, g in _PHASE_GLYPHS)
        out.append(f"           {legend}")
        out.append("")
        phase_s = loop.get("phase_s", {})
        phase_n = loop.get("phase_n", {})
        out.append(f"{'phase':<24} {'frac':>7} {'secs':>10} {'n':>8}")
        for name, _g in _PHASE_GLYPHS:
            if not (phase_frac.get(name) or phase_s.get(name)
                    or phase_n.get(name)):
                continue
            out.append(f"{name:<24} {_fmt(phase_frac.get(name, 0.0)):>7} "
                       f"{_fmt(phase_s.get(name, 0.0)):>10} "
                       f"{phase_n.get(name, 0):>8}")
    win = loop.get("window", {})
    if win:
        out.append("")
        out.append(f"window ({_fmt(win.get('wall_s'))} s of recent wall): "
                   f"device {_fmt(win.get('device_frac'))}, host overhead "
                   f"{_fmt(win.get('host_overhead_frac'))}, accounting "
                   f"{_fmt(win.get('accounting_frac'))}, idle "
                   f"{_fmt(win.get('idle_frac'))}")
    hists = loop.get("latency", {})
    if hists:
        out.append("")
        out.append(f"{'per-occurrence secs':<24} "
                   + " ".join(f"{c:>9}" for c in _HIST_COLS))
        for name, _g in _PHASE_GLYPHS:
            h = hists.get(name)
            if not h:
                continue
            out.append(f"{name:<24} "
                       + " ".join(f"{_fmt(h.get(c)):>9}" for c in _HIST_COLS))
    return out


def _render_fleet(loop: dict) -> list[str]:
    """Fleet view (the trainer plane's block: PoolManager sweeps)."""
    out: list[str] = []
    out.append(f"fleet ({loop.get('engines_reporting', 0)} engines "
               f"reporting): device frac min = "
               f"{_fmt(loop.get('device_frac_min'))}, accounting frac max "
               f"= {_fmt(loop.get('accounting_frac_max'))}")
    engines = loop.get("engines", [])
    if engines:
        out.append("")
        out.append(f"{'endpoint':<28} {'device_frac':>12} "
                   f"{'accounting_frac':>16}")
        for e in engines:
            out.append(f"{e.get('endpoint', '?'):<28} "
                       f"{_fmt(e.get('device_frac')):>12} "
                       f"{_fmt(e.get('accounting_frac')):>16}")
    return out


def render(loop: dict, ctx: dict) -> str:
    out = [f"Engine-loop profiler report — {ctx.get('source', '?')}"
           + (f" (role={ctx['role']}, {ctx.get('schema', '')})"
              if "role" in ctx else "")]
    if "counters" in ctx:
        c = ctx["counters"]
        out.append(f"bundle: {c.get('reason', '?')} at step "
                   f"{c.get('step', '?')} — {c.get('detail', '')}")
    out.append("")
    if not loop or not loop.get("enabled", False):
        out.append("loop profiler block is empty or disabled "
                   "(rollout.loop_profile=false, a pre-profiler engine, "
                   "or no engine reports it yet)")
    elif "phase_frac" in loop or "phase_s" in loop:
        out.extend(_render_engine(loop))
    elif "engines_reporting" in loop or "engines" in loop:
        out.extend(_render_fleet(loop))
    else:
        out.append(json.dumps(loop, indent=2))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render the engine-loop profiler (statusz `engine.loop`"
                    " block or a bundle's engine_profile.json) as a "
                    "one-page phase-bar report")
    ap.add_argument("target", help="host:port / statusz URL, a postmortem "
                                   "bundle dir, or a JSON file")
    args = ap.parse_args(argv)
    try:
        loop, ctx = load(args.target)
    except (OSError, ValueError) as exc:
        print(f"engine_report: {exc}", file=sys.stderr)
        return 2
    print(render(loop, ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
