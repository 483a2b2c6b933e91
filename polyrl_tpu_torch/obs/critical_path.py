"""Per-step critical-path extraction over the span ring (a copy of
``polyrl_tpu/obs/critical_path.py``).

The goodput ledger answers "how much wall did each phase COST"; this
module answers "which chain of spans actually BOUNDED the step". The
difference matters exactly when the pipeline overlaps lanes (OPPO in
PAPERS.md): with ``pipeline_depth>=1`` the producer lane can spend 0.8 s
generating while the foreground only BLOCKS 0.3 s of it — phase walls
then rank ``update`` above ``generate`` even though speeding the update
changes nothing. The extractor reconstructs the step's span tree from
the tracer ring (the ``trainer/step`` root, its same-trace children, the
``trainer/prefetch`` producer lane joined on its ``step`` attr — the
lane thread starts before any step span exists, so it owns its own
trace_id — and cross-process engine/manager spans joined on trace_id)
and sweeps the step window:

- every elementary interval is attributed to the **innermost foreground
  span** covering it (nested spans win, so colocated generation inside
  the ibatch wait reads ``generate``, not ``bubble``);
- a blocked interval (``trainer/ibatch_wait`` with no nested work) is
  attributed to ``generate`` when the producer lane's prefetch span
  covers it — the trainer is waiting ON generation — and to ``bubble``
  only when nothing anywhere is producing;
- the segment walls therefore partition the step wall exactly: their sum
  reconciles with ``goodput/step_wall_s`` by construction (pinned <=5%,
  like the goodput ledger's own attribution).

Per segment the extractor also totals the **hidden** time (span time
inside the window that the sweep did NOT surface — generation running
under the update phases). ``critical + hidden`` is the segment's full
chain length, and:

- ``bottleneck``   — the segment with the longest chain (argmax of
  totals; a fully-hidden 0.8 s generation outranks a 0.5 s update);
- ``slack_s``      — the tightest competitor's slack: min over the other
  active segments of ``wall - total(seg)`` — how much the bottleneck can
  improve before that phase binds instead;
- ``headroom_s``   — "if the bottleneck sped up 10%, the step wall drops
  by X": ``min(0.10 * total(bottleneck), slack_s)``.

Emitted as ``critpath/*`` step gauges (``bottleneck`` is the float index
into :data:`SEGMENTS` — the metrics plane is numeric), kept as dicts for
``critical_path.json`` flight-recorder bundles.
Import-light; pure function of the span records.
"""

from __future__ import annotations

SEGMENTS = ("generate", "process", "update", "push", "bubble", "manager",
            "housekeeping", "other")

ROOT_SPAN = "trainer/step"
LANE_SPAN = "trainer/prefetch"
WAIT_SPAN = "trainer/ibatch_wait"

# exact span-name -> segment (the marked_timer foreground phases plus the
# producer lane); names absent here fall through to the prefix rules.
# These are SPAN names, not metric keys, built under the "trainer/"
# span prefix.
_NAME_SEGMENT = {"trainer/" + phase: seg for phase, seg in {
    "gen": "generate",
    "reward": "process",
    "old_log_prob": "process",
    "ref_log_prob": "process",
    "values": "process",
    "adv": "process",
    "remax_baseline": "process",
    "broadcast": "process",
    "update_actor": "update",
    "update_critic": "update",
    "update_weight": "push",
    "prefetch_fence": "push",
    "testing": "housekeeping",
    "save_checkpoint": "housekeeping",
    "autoscale": "housekeeping",
}.items()}
_NAME_SEGMENT[LANE_SPAN] = "generate"
_PREFIX_SEGMENT = (
    ("rollout/", "generate"),   # remote stream rounds
    ("engine/", "generate"),    # engine-side spans (cross-process)
    ("manager/", "manager"),    # control-plane round trips
    ("transfer/", "push"),      # weight-fabric pack/wire/push
)


def classify(name: str) -> str | None:
    """Span name -> segment (None for spans outside the taxonomy —
    including the wait span, which is attributed by what covers it)."""
    if name == WAIT_SPAN:
        return None
    seg = _NAME_SEGMENT.get(name)
    if seg is not None:
        return seg
    for prefix, seg in _PREFIX_SEGMENT:
        if name.startswith(prefix):
            return seg
    return None


def _t0_us(rec: dict) -> int:
    # prefer the monotonic stamp (same-process comparisons survive wall-
    # clock steps); spans.jsonl predating it still carries ts_us
    return int(rec.get("ts_mono_us", rec.get("ts_us", 0)))


def _merged_len(intervals: list[tuple[int, int]]) -> int:
    """Total length of the union of [a, b) intervals."""
    total = 0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class CriticalPath:
    """One step's attribution: segment walls (``critical_s`` — partition
    of the step wall), hidden chain time, the ordered path, and the
    bottleneck/slack/headroom summary."""

    def __init__(self, *, step: int | None, wall_s: float,
                 critical_s: dict[str, float], hidden_s: dict[str, float],
                 path: list[tuple[str, float]], remote: list[dict]):
        self.step = step
        self.wall_s = wall_s
        self.critical_s = critical_s
        self.hidden_s = hidden_s
        self.path = path
        self.remote = remote
        self.total_s = {seg: critical_s.get(seg, 0.0) + hidden_s.get(seg, 0.0)
                        for seg in SEGMENTS}
        # argmax of chain totals; SEGMENTS order breaks exact ties
        self.bottleneck = max(SEGMENTS, key=lambda s: self.total_s[s])
        others = [self.wall_s - self.total_s[seg] for seg in SEGMENTS
                  if seg != self.bottleneck and self.total_s[seg] > 0.0]
        self.slack_s = max(0.0, min(others)) if others else self.wall_s
        self.headroom_s = max(0.0, min(
            0.10 * self.total_s[self.bottleneck], self.slack_s))

    def metrics(self) -> dict[str, float]:
        """``critpath/*`` step gauges (all-float: ``bottleneck`` is the
        index into :data:`SEGMENTS`)."""
        wall = max(self.wall_s, 1e-9)
        out = {
            "critpath/wall_s": self.wall_s,
            "critpath/bottleneck": float(SEGMENTS.index(self.bottleneck)),
            "critpath/bottleneck_frac": self.total_s[self.bottleneck] / wall,
            "critpath/slack_s": self.slack_s,
            "critpath/headroom_s": self.headroom_s,
        }
        for seg in SEGMENTS:
            out[f"critpath/{seg}_frac"] = self.critical_s.get(seg, 0.0) / wall
        return out

    def to_dict(self) -> dict:
        """JSON view (``critical_path.json`` bundles, fleet_report)."""
        return {
            "step": self.step,
            "wall_s": round(self.wall_s, 6),
            "bottleneck": self.bottleneck,
            "slack_s": round(self.slack_s, 6),
            "headroom_s": round(self.headroom_s, 6),
            "critical_s": {k: round(v, 6)
                           for k, v in self.critical_s.items() if v > 0.0},
            "hidden_s": {k: round(v, 6)
                         for k, v in self.hidden_s.items() if v > 0.0},
            "path": [[seg, round(dur, 6)] for seg, dur in self.path],
            "remote": self.remote,
        }


def extract_critical_path(records: list[dict], *, step: int | None = None,
                          wall_s: float | None = None,
                          max_remote: int = 16) -> CriticalPath | None:
    """Extract one step's critical path from raw span records
    (``Tracer.records()`` or a parsed ``spans.jsonl``).

    ``step`` selects the ``trainer/step`` root by its ``step`` attr (the
    LAST match wins — a warmup fit's ring leftovers don't shadow the live
    run); None takes the latest root. ``wall_s`` is the step's full
    goodput wall (the root span ends before validation/checkpoint/scrape,
    so the window is extended to the wall and the trailing housekeeping
    spans attribute); None falls back to the root span's own duration.
    Returns None when no matching root exists (tracing off, ring evicted).
    """
    roots = [r for r in records if r.get("name") == ROOT_SPAN]
    if step is not None:
        roots = [r for r in roots
                 if (r.get("attrs") or {}).get("step") == step]
    if not roots:
        return None
    root = max(roots, key=_t0_us)
    t0 = _t0_us(root)
    root_dur = int(root.get("dur_us", 0))
    wall_us = max(root_dur, int(wall_s * 1e6) if wall_s else 0, 1)
    t1 = t0 + wall_us

    pid, tid = root.get("pid"), root.get("tid")
    trace_ids = {root.get("trace_id")}
    fg: list[tuple[int, int, str]] = []      # (start, end, name), clipped
    lane: list[tuple[int, int]] = []         # producer prefetch intervals
    by_seg: dict[str, list[tuple[int, int]]] = {s: [] for s in SEGMENTS}
    remote: list[dict] = []

    for rec in records:
        if rec is root:
            continue
        s0 = _t0_us(rec)
        s1 = s0 + int(rec.get("dur_us", 0))
        a, b = max(s0, t0), min(s1, t1)
        if a >= b:
            continue
        name = str(rec.get("name", ""))
        if rec.get("pid") != pid:
            # cross-process chain members, joined on the step's trace ids
            if rec.get("trace_id") in trace_ids:
                remote.append({"name": name, "pid": rec.get("pid"),
                               "dur_s": round((s1 - s0) / 1e6, 6),
                               "span_id": rec.get("span_id", "")})
            continue
        if name == LANE_SPAN:
            trace_ids.add(rec.get("trace_id"))
            lane.append((a, b))
            by_seg["generate"].append((a, b))
            continue
        seg = classify(name)
        if seg is not None:
            by_seg[seg].append((a, b))
        if rec.get("tid") == tid and (seg is not None or name == WAIT_SPAN):
            fg.append((a, b, name))

    # elementary-interval sweep over the foreground boundaries: innermost
    # covering span wins; a bare wait is generate when the lane covers it
    bounds = sorted({t0, t1} | {x for a, b, _ in fg for x in (a, b)
                    if t0 <= x <= t1})
    lane_sorted = sorted(lane)
    path: list[tuple[str, int]] = []
    for a, b in zip(bounds, bounds[1:]):
        if a >= b:
            continue
        mid = (a + b) // 2
        covering = [(sa, sb, nm) for sa, sb, nm in fg if sa <= mid < sb]
        if covering:
            # innermost = latest start (ties: earliest end — the smaller
            # span is the deeper one)
            sa, sb, nm = max(covering, key=lambda s: (s[0], -s[1]))
            seg = classify(nm)
            if seg is None:  # the wait span: blocked — on whom?
                seg = "generate" if any(la <= mid < lb
                                        for la, lb in lane_sorted) \
                    else "bubble"
        else:
            seg = "other"
        if path and path[-1][0] == seg:
            path[-1] = (seg, path[-1][1] + (b - a))
        else:
            path.append((seg, b - a))

    critical_us = {s: 0.0 for s in SEGMENTS}
    for seg, dur in path:
        critical_us[seg] += dur
    critical_s = {s: v / 1e6 for s, v in critical_us.items()}
    hidden_s = {
        seg: max(0.0, _merged_len(ivals) / 1e6 - critical_s[seg])
        for seg, ivals in by_seg.items() if ivals}
    remote.sort(key=lambda r: -r["dur_s"])
    step_attr = (root.get("attrs") or {}).get("step", step)
    return CriticalPath(
        step=step_attr if isinstance(step_attr, int) else step,
        wall_s=wall_us / 1e6,
        critical_s=critical_s, hidden_s=hidden_s,
        path=[(seg, dur / 1e6) for seg, dur in path],
        remote=remote[:max_remote])
