"""Convert span-record JSONL dumps into one Perfetto-loadable trace.

Each process in a disaggregated run (trainer, rollout servers) dumps its
own ``spans.jsonl`` (obs/trace.py ``export_run``). This tool merges any
number of them into a single Chrome trace-event JSON that Perfetto
(https://ui.perfetto.dev) or chrome://tracing loads directly; spans from
different processes line up on the shared wall clock and carry their
``trace_id`` in ``args`` so one rollout request can be followed
trainer→manager→engine.

Alignment: each dump leads with a per-process ``clock_anchor`` record
(monotonic↔wall pairing); spans are placed at
``anchor.wall_us - (anchor.mono_us - span.ts_mono_us)`` so a wall-clock
step between a span's start and the export can't overlap two processes'
timelines wrongly (obs/trace.py ``chrome_trace``). Dumps predating the
anchor still merge on their raw wall stamps.

Usage:
    python -m polyrl_tpu_torch.tools.trace2perfetto run_a/spans.jsonl run_b/spans.jsonl \
        -o trace.json
    python -m polyrl_tpu_torch.tools.trace2perfetto trace_dir/        # finds spans.jsonl

A copy of ``tools/trace2perfetto.py`` over the port's own observability modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from polyrl_tpu_torch.obs.trace import chrome_trace, is_clock_anchor


def load_spans(paths: list[str]) -> list[dict]:
    records: list[dict] = []
    for path in paths:
        if os.path.isdir(path):
            path = os.path.join(path, "spans.jsonl")
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    print(f"warning: {path}:{lineno}: bad span line skipped",
                          file=sys.stderr)
    records.sort(key=lambda r: r.get("ts_us", 0))
    return records


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("inputs", nargs="+",
                        help="spans.jsonl files (or dirs containing one)")
    parser.add_argument("-o", "--out", default="trace.json",
                        help="output Chrome/Perfetto trace JSON")
    args = parser.parse_args(argv)
    records = load_spans(args.inputs)
    spans = [r for r in records if not is_clock_anchor(r)]
    if not spans:
        print("no spans found", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(chrome_trace(records), f)
    traces = {r.get("trace_id") for r in spans}
    anchors = sum(1 for r in records if is_clock_anchor(r))
    print(f"{args.out}: {len(spans)} spans, {len(traces)} traces, "
          f"{anchors} clock anchors — open in https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
