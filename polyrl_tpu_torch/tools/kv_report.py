"""One-page KV memory plane report (ARCHITECTURE.md "KV memory plane").

Renders the ``memory`` statusz section — the per-page ledger's role
counts, hot/warm/cold residency tiers, churn + free-cause split, the
ledger↔pool reconciliation block, page-lifetime histograms and HBM truth
(rollout/kvledger.py) — as text, from any of:

- a live plane: ``host:port`` or ``http://host:port`` (GET /statusz;
  works on both roles — the rollout plane serves its engine's ledger,
  the trainer the fleet worst-case view);
- a flight-recorder post-mortem bundle dir (reads its ``memory.json``
  plus the bundle reason from ``counters.json``);
- a JSON file: a saved ``memory.json`` or a whole statusz snapshot.

Usage::

    python -m polyrl_tpu_torch.tools.kv_report 127.0.0.1:30000
    python -m polyrl_tpu_torch.tools.kv_report runs/postmortem/001-anomaly/
    python -m polyrl_tpu_torch.tools.kv_report memory.json

A copy of ``tools/kv_report.py`` over the port's own observability modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

_HIST_COLS = ("p50", "p95", "p99", "max", "mean", "count")


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


def _gb(b: float) -> str:
    return f"{b / 1e9:.3f} GB" if b else "0"


def load(target: str) -> tuple[dict, dict]:
    """``(memory section, context)`` from a URL, bundle dir, or JSON file.
    A full statusz snapshot yields its ``memory`` key; context carries the
    source + the bundle's counters.json when present."""
    ctx: dict = {"source": target}
    if os.path.isdir(target):
        cpath = os.path.join(target, "counters.json")
        if os.path.exists(cpath):
            try:
                with open(cpath) as f:
                    ctx["counters"] = json.load(f)
            except ValueError:
                pass
        target = os.path.join(target, "memory.json")
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
    if "schema" in doc and "memory" in doc:
        ctx["role"] = doc.get("role", "?")
        ctx["schema"] = doc.get("schema", "?")
        doc = doc["memory"] or {}
    return doc, ctx


def _render_ledger(mem: dict) -> list[str]:
    """Single-engine ledger snapshot (the rollout plane's section)."""
    out: list[str] = []
    roles = mem.get("roles", {})
    total = sum(int(v) for v in roles.values()) or 1
    out.append(f"{'role':<24} {'pages':>8} {'frac':>7}")
    for name, n in roles.items():
        out.append(f"{name:<24} {int(n):>8} {int(n) / total:>7.3f}")
    tiers = mem.get("tiers", {})
    if tiers:
        out.append("")
        out.append(f"residency tiers (warm after "
                   f"{tiers.get('warm_after_dispatches', '?')}, cold after "
                   f"{tiers.get('cold_after_dispatches', '?')} idle "
                   f"dispatches; now at dispatch {mem.get('dispatch', '?')}):")
        resident = sum(int(tiers.get(k, 0))
                       for k in ("hot", "warm", "cold")) or 1
        for k in ("hot", "warm", "cold"):
            n = int(tiers.get(k, 0))
            out.append(f"  {k:<6} {n:>8} pages ({n / resident:>6.1%} of "
                       f"resident)")
        out.append(f"  cold bytes: {_gb(float(tiers.get('cold_bytes', 0)))}")
    rec = mem.get("reconcile", {})
    if rec:
        out.append("")
        frac = rec.get("attributed_frac")
        flag = "" if frac in (None, 1, 1.0) else \
            "  <-- mismatch (transient mid-churn; persistent = leak)"
        out.append(f"reconciliation: attributed_frac = {_fmt(frac)}{flag}")
        out.append(f"  ledger free  {rec.get('ledger_free', '?'):>8}  vs "
                   f"pool free list {rec.get('pool_free', '?')}")
        out.append(f"  ledger cache {rec.get('ledger_cache', '?'):>8}  vs "
                   f"cache resident {rec.get('cache_pages', '?')}")
    spill = mem.get("spill", {})
    if spill:
        out.append("")
        out.append(f"host spill tier: {spill.get('spilled_pages', 0)} pages "
                   f"({_gb(float(spill.get('spilled_bytes', 0)))}) on host; "
                   f"{spill.get('pages_spilled', 0)} spilled / "
                   f"{spill.get('pages_restored', 0)} restored / "
                   f"{spill.get('spill_drops', 0)} dropped; "
                   f"restore rate {_fmt(spill.get('restore_rate'))} "
                   f"pages/dispatch")
        out.append(f"  traffic: {_gb(float(spill.get('spill_bytes', 0)))} "
                   f"out, {_gb(float(spill.get('restore_bytes', 0)))} back")
        host = spill.get("host", {})
        if host:
            out.append(f"  host pool: {host.get('resident_pages', 0)} pages "
                       f"resident ({_gb(float(host.get('resident_bytes', 0)))}"
                       f" of {_gb(float(host.get('capacity_bytes', 0)))}), "
                       f"{host.get('copy_batches', 0)} copy batches, "
                       f"{host.get('sync_fetches', 0)} sync fetches, "
                       f"lane {host.get('lane_inflight', 0)}/"
                       f"{host.get('lane_depth', 0)}")
    churn = mem.get("churn", {})
    if churn:
        out.append("")
        out.append(f"churn: {churn.get('page_allocs', 0)} allocs, "
                   f"{churn.get('page_frees', 0)} frees, "
                   f"{churn.get('page_publishes', 0)} publishes")
        by_cause = churn.get("freed_by_cause", {})
        freed = [(c, n) for c, n in by_cause.items() if n]
        if freed:
            out.append("  freed by cause: " + ", ".join(
                f"{c}={n}" for c, n in sorted(freed, key=lambda kv: -kv[1])))
    hists = mem.get("hists", {})
    if hists:
        out.append("")
        out.append(f"{'lifetime (dispatches)':<28} "
                   + " ".join(f"{c:>8}" for c in _HIST_COLS))
        for name, h in hists.items():
            out.append(f"{name:<28} "
                       + " ".join(f"{_fmt(h.get(c)):>8}" for c in _HIST_COLS))
    owners = mem.get("top_owners", {})
    if owners:
        out.append("")
        out.append("top owners (active/preref pages):")
        for rid, n in owners.items():
            out.append(f"  {n:>6} pages  {rid}")
    hbm = mem.get("hbm", {})
    if hbm:
        out.append("")
        out.append(f"HBM truth: used {_fmt(hbm.get('hbm_used_gb'))} GB"
                   + (f", headroom {_fmt(hbm.get('hbm_headroom_gb'))} GB"
                      if "hbm_headroom_gb" in hbm else "")
                   + f", unaccounted {_fmt(hbm.get('hbm_unaccounted_gb'))}"
                   f" GB (accounted: "
                   f"{_gb(float(mem.get('accounted_bytes', 0)))})")
    elif "accounted_bytes" in mem:
        out.append("")
        out.append(f"HBM truth: no device stats (CPU backend); ledger "
                   f"accounts {_gb(float(mem.get('accounted_bytes', 0)))}")
    return out


def _render_fleet(mem: dict) -> list[str]:
    """Fleet view (the trainer plane's section: PoolManager sweeps)."""
    out: list[str] = []
    fleet = mem.get("fleet", {})
    out.append(f"fleet ({fleet.get('engines_reporting', 0)} engines "
               f"reporting): cold frac max = "
               f"{_fmt(fleet.get('kv_cold_page_frac_max'))}"
               + (f", HBM headroom min = "
                  f"{_fmt(fleet.get('hbm_headroom_gb_min'))} GB"
                  if "hbm_headroom_gb_min" in fleet else "")
               + (f", spilled frac max = "
                  f"{_fmt(fleet.get('kv_spilled_frac_max'))}"
                  if "kv_spilled_frac_max" in fleet else "")
               + (f", restore rate max = "
                  f"{_fmt(fleet.get('kv_restore_rate_max'))}"
                  if "kv_restore_rate_max" in fleet else ""))
    engines = mem.get("engines", [])
    if engines:
        out.append("")
        out.append(f"{'endpoint':<28} {'cold_frac':>10} {'headroom_gb':>12} "
                   f"{'spilled':>8} {'restore/d':>10}")
        for e in engines:
            out.append(f"{e.get('endpoint', '?'):<28} "
                       f"{_fmt(e.get('kv_cold_page_frac')):>10} "
                       f"{_fmt(e.get('hbm_headroom_gb')):>12} "
                       f"{_fmt(e.get('kv_spilled_frac')):>8} "
                       f"{_fmt(e.get('kv_restore_rate')):>10}")
    return out


def render(mem: dict, ctx: dict) -> str:
    out = [f"KV memory plane report — {ctx.get('source', '?')}"
           + (f" (role={ctx['role']}, {ctx.get('schema', '')})"
              if "role" in ctx else "")]
    if "counters" in ctx:
        c = ctx["counters"]
        out.append(f"bundle: {c.get('reason', '?')} at step "
                   f"{c.get('step', '?')} — {c.get('detail', '')}")
    out.append("")
    if not mem:
        out.append("memory section is empty — ledger off "
                   "(rollout.kv_ledger=false), or no engine reports it yet")
    elif "roles" in mem:
        out.extend(_render_ledger(mem))
    elif "fleet" in mem or "engines" in mem:
        out.extend(_render_fleet(mem))
    else:
        out.append(json.dumps(mem, indent=2))
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render the KV memory plane (statusz `memory` section "
                    "or a bundle's memory.json) as a one-page report")
    ap.add_argument("target", help="host:port / statusz URL, a postmortem "
                                   "bundle dir, or a JSON file")
    args = ap.parse_args(argv)
    try:
        mem, ctx = load(args.target)
    except (OSError, ValueError) as exc:
        print(f"kv_report: {exc}", file=sys.stderr)
        return 2
    print(render(mem, ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
