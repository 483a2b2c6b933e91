"""Span tracer: thread-local context, bounded ring buffer, Perfetto export.

A copy of ``polyrl_tpu/obs/trace.py`` (the port keeps its own).

Span model:

- a *trace* is one logical operation followed across threads and processes
  (one training step, one rollout batch); all its spans share ``trace_id``.
- a *span* is one timed phase with a ``span_id`` and a ``parent_id``;
  nesting comes from a thread-local span stack, so ``with span(...)``
  blocks compose without plumbing.
- context crosses threads via ``capture()``/``adopt()`` and processes via
  the ``X-Trace-Id``/``X-Span-Id`` HTTP headers (``Tracer.headers()``);
  the C++ manager echoes the pair into the requests it forwards, so a
  rollout server adopts the trainer's trace for its engine spans.

Memory is bounded: finished spans land in a ``deque(maxlen=max_spans)``
ring buffer (oldest evicted, ``dropped`` counts evictions) — a tracer left
on for a week-long run costs a fixed few MB, never an OOM.

Export is Chrome trace-event JSON (the format Perfetto/chrome://tracing
load directly): ``export_run()`` writes ``spans.jsonl`` (raw records, one
per line — the cross-process merge input for tools/trace2perfetto.py) and
``trace.json`` next to the run's JSONL metrics.

Clock model: spans stamp ``ts_us`` from the wall clock (cross-process
alignment) but ``dur_us`` AND ``ts_mono_us`` from the monotonic clock
(an NTP step mid-span must not corrupt durations or same-process
ordering). Each ``spans.jsonl`` leads with one ``clock_anchor`` record —
``{"type": "clock_anchor", "pid", "wall_us", "mono_us"}``, both clocks
sampled at the same instant — so a merger (:func:`chrome_trace`,
tools/trace2perfetto.py) can place every span at
``wall_us - (mono_us - span.ts_mono_us)``: monotonic spacing within a
process, wall alignment across processes, immune to clock steps between
the stamps.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import uuid

_SEQ = itertools.count(1)


def _new_span_id() -> str:
    # unique across processes: pid + per-process counter
    return f"{os.getpid():x}.{next(_SEQ):x}"


class Tracer:
    def __init__(self, enabled: bool = False, max_spans: int = 4096,
                 out_dir: str | None = None):
        self.enabled = enabled
        self.out_dir = out_dir
        self.dropped = 0
        self._buf: collections.deque = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- context ------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> tuple[str, str] | None:
        """(trace_id, span_id) of the innermost open span on THIS thread,
        falling back to an adopted remote/cross-thread context."""
        st = self._stack()
        if st:
            return st[-1][0], st[-1][1]
        return getattr(self._tls, "adopted", None)

    def capture(self) -> tuple[str, str] | None:
        """Snapshot the current context for hand-off to another thread."""
        return self.current()

    @contextlib.contextmanager
    def adopt(self, ctx: tuple[str, str] | None):
        """Parent subsequent spans on this thread under ``ctx`` (a
        ``capture()`` result or a propagated (trace_id, span_id) pair).
        No-op for None or when disabled."""
        if not self.enabled or ctx is None:
            yield
            return
        prev = getattr(self._tls, "adopted", None)
        self._tls.adopted = (str(ctx[0]), str(ctx[1]))
        try:
            yield
        finally:
            self._tls.adopted = prev

    def headers(self) -> dict[str, str]:
        ctx = self.current()
        if not self.enabled or ctx is None:
            return {}
        return {"X-Trace-Id": ctx[0], "X-Span-Id": ctx[1]}

    # -- spans --------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield None
            return
        parent = self.current()
        trace_id = parent[0] if parent else uuid.uuid4().hex[:16]
        span_id = _new_span_id()
        st = self._stack()
        st.append((trace_id, span_id))
        t0_wall = time.time()
        t0 = time.monotonic()
        error = ""
        try:
            yield span_id
        except BaseException as exc:
            error = repr(exc)
            raise
        finally:
            st.pop()
            rec = {
                "name": name,
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_id": parent[1] if parent else "",
                "ts_us": int(t0_wall * 1e6),
                "ts_mono_us": int(t0 * 1e6),
                "dur_us": int((time.monotonic() - t0) * 1e6),
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
            }
            if attrs:
                rec["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
            if error:
                rec["error"] = error
            with self._lock:
                if len(self._buf) == self._buf.maxlen:
                    self.dropped += 1
                self._buf.append(rec)

    # -- buffer management --------------------------------------------------

    @property
    def max_spans(self) -> int:
        return self._buf.maxlen or 0

    def set_capacity(self, max_spans: int) -> None:
        with self._lock:
            self._buf = collections.deque(self._buf, maxlen=max_spans)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    # -- export -------------------------------------------------------------

    def export_run(self, out_dir: str | None = None) -> tuple[str, str] | None:
        """Dump ``spans.jsonl`` + Perfetto-loadable ``trace.json`` into
        ``out_dir`` (falls back to the configured one); None when there is
        nowhere to write."""
        out_dir = out_dir or self.out_dir
        if not out_dir:
            return None
        os.makedirs(out_dir, exist_ok=True)
        records = self.records()
        # ONE anchor for both artifacts: the jsonl leads with it and the
        # inline chrome trace is placed on it, so the two dumps agree
        anchor = clock_anchor()
        jsonl = os.path.join(out_dir, "spans.jsonl")
        with open(jsonl, "w") as f:
            f.write(json.dumps(anchor) + "\n")
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        trace = os.path.join(out_dir, "trace.json")
        with open(trace, "w") as f:
            json.dump(chrome_trace([anchor] + records), f)
        return jsonl, trace


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else repr(v)


def clock_anchor() -> dict:
    """One process's monotonic↔wall pairing, both clocks sampled now —
    the per-process alignment record leading every ``spans.jsonl``."""
    return {"type": "clock_anchor", "pid": os.getpid(),
            "wall_us": int(time.time() * 1e6),
            "mono_us": int(time.monotonic() * 1e6)}


def is_clock_anchor(rec: dict) -> bool:
    return rec.get("type") == "clock_anchor"


def chrome_trace(records: list[dict]) -> dict:
    """Span records → Chrome trace-event JSON (Perfetto/chrome://tracing).
    Spans become ``ph:"X"`` complete events; trace/span/parent ids ride in
    ``args`` so Perfetto's query view can join across processes.

    ``clock_anchor`` records are consumed, not emitted: a span carrying
    ``ts_mono_us`` whose process has an anchor is placed at
    ``anchor.wall_us - (anchor.mono_us - ts_mono_us)`` — monotonic
    spacing within the process, anchored to the wall for cross-process
    alignment, so merged timelines survive a wall-clock step between the
    span stamp and the export. Spans without an anchor (or predating
    ``ts_mono_us``) keep their raw wall ``ts_us``."""
    anchors = {rec["pid"]: rec for rec in records if is_clock_anchor(rec)}
    events = []
    pids = {}
    for rec in records:
        if is_clock_anchor(rec):
            continue
        pids.setdefault(rec["pid"], None)
        args = {"trace_id": rec["trace_id"], "span_id": rec["span_id"],
                "parent_id": rec.get("parent_id", "")}
        args.update(rec.get("attrs", {}))
        if rec.get("error"):
            args["error"] = rec["error"]
        anchor = anchors.get(rec["pid"])
        if anchor is not None and "ts_mono_us" in rec:
            ts = anchor["wall_us"] - (anchor["mono_us"] - rec["ts_mono_us"])
        else:
            ts = rec["ts_us"]
        events.append({
            "name": rec["name"],
            "cat": rec["name"].split("/", 1)[0],
            "ph": "X",
            "ts": ts,
            "dur": rec["dur_us"],
            "pid": rec["pid"],
            "tid": rec["tid"],
            "args": args,
        })
    for pid in pids:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"polyrl pid {pid}"}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
