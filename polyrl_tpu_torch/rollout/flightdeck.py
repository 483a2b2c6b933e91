"""Engine flight deck: per-request lifecycle and scheduler occupancy
ledger.

The port's own copy of ``polyrl_tpu/rollout/flightdeck.py``. Two ledgers,
one invariant:

- **Request ledger** -- every admitted request's queue wait (submit to
  admission dispatch), prefill wall (admission to first token), TTFT
  (submit to first token), mean decode interval (TPOT), and prefill vs
  decode token counts. Distributions land in engine-local log2 histograms
  (served by ``server_info`` without a trainer attached) and in the
  process-global registry (``engine/ttft_s``, ``engine/tpot_s``,
  ``engine/queue_wait_s``, ``engine/prefill_s``), so a colocated engine's
  tails ride the trainer's step records.
- **Scheduler step ledger** -- per-decode-dispatch occupancy (active slots
  / max_slots, pad fraction), page-allocator utilization and prefix-cache
  residency, run-ahead depth (dispatch outputs in flight), and admission
  wave sizes; plus the KV-read ledger (pages the decode kernels stream
  against pages logically attended).

The two sides count nothing twice and must reconcile: scheduler-side token
totals (counted at admission dispatch and at emission) equal the
per-request totals folded in at finalize, exactly, whenever the engine is
quiescent; ``attributed_frac`` is the live ratio. A leaked slot, a skipped
finalize, or an emission past a dead slot breaks the equality.

All mutation happens on the engine loop thread; readers (HTTP handler
threads serving ``server_info``) take the same lock.
"""

from __future__ import annotations

import math
import threading
import time

from polyrl_tpu_torch.obs.histogram import Histogram, observe


class ThroughputEWMA:
    """Time-aware EWMA over throughput samples: the weight adapts to the
    gap between samples (``alpha = 1 - exp(-dt/tau)``), so irregular
    emission bursts are smoothed over ``tau`` seconds of wall time rather
    than a fixed sample count."""

    def __init__(self, tau_s: float = 5.0):
        self.tau_s = float(tau_s)
        self.value = 0.0
        self._t_last: float | None = None

    def update(self, rate: float, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if self._t_last is None:
            self.value = float(rate)
        else:
            dt = max(0.0, now - self._t_last)
            alpha = 1.0 - math.exp(-dt / self.tau_s) if self.tau_s > 0 else 1.0
            self.value += alpha * (float(rate) - self.value)
        self._t_last = now
        return self.value

    def reset(self) -> None:
        self.value = 0.0
        self._t_last = None


class _ReqRecord:
    """Lifecycle of one admitted request (slot-resident)."""

    __slots__ = ("rid", "t_submit", "t_admit", "t_first", "t_last",
                 "prefill_tokens", "cached_tokens", "decode_tokens",
                 "salvaged")

    def __init__(self, rid: str, t_submit: float, t_admit: float,
                 prefill_tokens: int, cached_tokens: int):
        self.rid = rid
        self.t_submit = t_submit
        self.t_admit = t_admit
        self.t_first = 0.0
        self.t_last = 0.0
        self.prefill_tokens = prefill_tokens
        self.cached_tokens = cached_tokens
        self.decode_tokens = 0
        self.salvaged = False


class EngineFlightDeck:
    """Both ledgers + the reconciliation invariant for one CBEngine."""

    # EWMA weight for the per-dispatch occupancy signal exported to the
    # manager's placement view (dispatches are sub-second; ~0.05 smooths
    # over a few dozen dispatches without hiding a real collapse)
    OCC_ALPHA = 0.05

    def __init__(self, max_slots: int, num_pages: int, page_size: int):
        self.max_slots = max(1, int(max_slots))
        # page 0 is the reserved null page — it can never be allocated
        self.num_alloc_pages = max(1, int(num_pages) - 1)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._recs: list[_ReqRecord | None] = [None] * self.max_slots

        # request-side cumulative totals (folded at finalize)
        self.req_prefill_tokens = 0
        self.req_decode_tokens = 0
        self.requests_finished = 0
        self.requests_salvaged = 0
        # scheduler-side cumulative totals (counted at dispatch/emission)
        self.sched_prefill_tokens = 0
        self.sched_decode_tokens = 0
        # prompt tokens served from cached/group-shared pages instead of
        # being recomputed (group-shared prefill headline signal):
        # prefill_reuse_frac = cached / sched_prefill. Counted at admission
        # like sched_prefill_tokens — reuse is a scheduler-side property.
        self.cached_prompt_tokens = 0

        # KV-read ledger (shared-prefix decode attention): pages the decode
        # kernels actually STREAM from HBM vs pages LOGICALLY attended —
        # each decode group's shared prefix streams once per group instead
        # of once per sibling, and this ledger is what quantifies the
        # bandwidth actually deduplicated (engine/kv_read_pages_per_token,
        # engine/shared_prefix_read_frac). Counts are dispatch-time
        # estimates from the host mirrors (each fused step can cross at
        # most one page boundary past the sample).
        self.kv_pages_streamed = 0
        self.kv_pages_logical = 0
        self.kv_read_tokens = 0

        # scheduler step ledger (updated per decode dispatch / admission)
        self.decode_dispatches = 0
        self.idle_iters = 0
        self.admit_waves = 0
        self.admitted_requests = 0
        self.occupancy_last = 0.0
        self.occupancy_ewma = 0.0
        self.pad_frac_last = 0.0
        self.page_util_last = 0.0
        self.page_util_peak = 0.0
        self.cache_pages_last = 0
        self.run_ahead_last = 0
        self.queued_last = 0

        # engine-local distributions (cumulative — a standalone rollout
        # server has no trainer draining the global registry)
        self.hists: dict[str, Histogram] = {
            "ttft_s": Histogram(),
            "tpot_s": Histogram(),
            "queue_wait_s": Histogram(),
            "prefill_s": Histogram(),
            "occupancy": Histogram(),
            "page_util": Histogram(),
            "admit_batch": Histogram(),
        }

    # -- request lifecycle (loop thread) ------------------------------------

    def on_admit(self, slot: int, rid: str, t_submit: float,
                 prompt_tokens: int, cached_tokens: int = 0) -> None:
        """Admission dispatch for ``slot``: queue wait ends here; the
        request's prompt joins the scheduler-side prefill total."""
        now = time.monotonic()
        qw = max(0.0, now - t_submit)
        with self._lock:
            self._recs[slot] = _ReqRecord(rid, t_submit, now,
                                          int(prompt_tokens),
                                          int(cached_tokens))
            self.sched_prefill_tokens += int(prompt_tokens)
            self.cached_prompt_tokens += int(cached_tokens)
            self.admitted_requests += 1
            self.hists["queue_wait_s"].observe(qw)
        observe("engine/queue_wait_s", qw)

    def on_admit_wave(self, n: int) -> None:
        with self._lock:
            self.admit_waves += 1
            self.hists["admit_batch"].observe(float(n))

    def on_first_token(self, slot: int) -> None:
        now = time.monotonic()
        with self._lock:
            rec = self._recs[slot]
            if rec is None or rec.t_first:
                return
            rec.t_first = rec.t_last = now
            rec.decode_tokens += 1
            ttft = max(0.0, now - rec.t_submit)
            prefill = max(0.0, now - rec.t_admit)
            self.hists["ttft_s"].observe(ttft)
            self.hists["prefill_s"].observe(prefill)
        observe("engine/ttft_s", ttft)
        observe("engine/prefill_s", prefill)

    def on_decode(self, slot: int, n: int = 1) -> None:
        with self._lock:
            rec = self._recs[slot]
            if rec is None:
                return
            rec.decode_tokens += int(n)
            rec.t_last = time.monotonic()

    def on_emitted(self, n: int) -> None:
        """Scheduler-side emission total (the ``_count_tokens`` seam —
        counted independently of the per-slot records above so the
        reconciliation actually checks something)."""
        with self._lock:
            self.sched_decode_tokens += int(n)

    def on_salvage(self, slot: int) -> None:
        with self._lock:
            rec = self._recs[slot]
            if rec is not None:
                rec.salvaged = True

    def on_finalize(self, slot: int) -> None:
        """Fold the slot's record into the request-side totals; observe its
        mean decode interval (TPOT). Idempotent — a double finalize (abort
        racing a stop-token finish) folds once."""
        with self._lock:
            rec = self._recs[slot]
            if rec is None:
                return
            self._recs[slot] = None
            self.req_prefill_tokens += rec.prefill_tokens
            self.req_decode_tokens += rec.decode_tokens
            self.requests_finished += 1
            if rec.salvaged:
                self.requests_salvaged += 1
            tpot = None
            if rec.decode_tokens > 1 and rec.t_last > rec.t_first:
                tpot = (rec.t_last - rec.t_first) / (rec.decode_tokens - 1)
                self.hists["tpot_s"].observe(tpot)
        if tpot is not None:
            observe("engine/tpot_s", tpot)

    # -- scheduler step ledger (loop thread) --------------------------------

    def on_dispatch(self, active: int, free_pages: int, cache_pages: int,
                    run_ahead: int, queued: int) -> None:
        """One decode dispatch: sample occupancy + page pressure."""
        occ = min(1.0, active / self.max_slots)
        util = min(1.0, 1.0 - free_pages / self.num_alloc_pages)
        with self._lock:
            self.decode_dispatches += 1
            self.occupancy_last = occ
            if self.decode_dispatches == 1:  # seed, don't ramp from zero
                self.occupancy_ewma = occ
            else:
                self.occupancy_ewma += self.OCC_ALPHA * (occ
                                                         - self.occupancy_ewma)
            self.pad_frac_last = 1.0 - occ
            self.page_util_last = util
            self.page_util_peak = max(self.page_util_peak, util)
            self.cache_pages_last = int(cache_pages)
            self.run_ahead_last = int(run_ahead)
            self.queued_last = int(queued)
            self.hists["occupancy"].observe(occ)
            self.hists["page_util"].observe(util)

    def on_kv_read(self, streamed_pages: int, logical_pages: int,
                   tokens: int) -> None:
        """One decode dispatch's KV-read sample (``_account_kv_reads``)."""
        with self._lock:
            self.kv_pages_streamed += int(streamed_pages)
            self.kv_pages_logical += int(logical_pages)
            self.kv_read_tokens += int(tokens)

    def on_idle(self) -> None:
        with self._lock:
            self.idle_iters += 1

    # -- export --------------------------------------------------------------

    def attributed_frac(self) -> float:
        """Request-attributed tokens / scheduler-observed tokens. Exactly
        1.0 at quiescence; < 1.0 while requests are in flight; anything
        > 1.0 is a double-count bug."""
        sched = self.sched_prefill_tokens + self.sched_decode_tokens
        if sched == 0:
            return 1.0
        return (self.req_prefill_tokens + self.req_decode_tokens) / sched

    def prefill_reuse_frac(self) -> float:
        """Fraction of admitted prompt tokens whose KV came from the prefix
        cache / a group-shared leader instead of being recomputed — the
        group-shared-prefill headline. 0.0 before any admission."""
        if self.sched_prefill_tokens == 0:
            return 0.0
        return self.cached_prompt_tokens / self.sched_prefill_tokens

    def kv_read_pages_per_token(self) -> float:
        """KV pages streamed from HBM per decoded token — the bandwidth
        cost the shared-prefix decode kernel attacks. 0.0 before any
        decode dispatch."""
        if self.kv_read_tokens == 0:
            return 0.0
        return self.kv_pages_streamed / self.kv_read_tokens

    def shared_prefix_read_frac(self) -> float:
        """Fraction of logically-attended KV pages the decode kernels did
        NOT re-stream (deduplicated by the grouped prefix phase). 0.0 with
        sharing off or no group traffic; → (G−1)/G · prefix share of the
        sequence on a pure G-sibling workload."""
        if self.kv_pages_logical == 0:
            return 0.0
        return 1.0 - self.kv_pages_streamed / self.kv_pages_logical

    def server_info_fields(self) -> dict:
        """Flat keys merged into ``server_info``: what the C++ manager's
        stats poller forwards. Names stay flat (no ``/``) so the C++ json
        parser indexes them directly."""
        with self._lock:
            t = self.hists["ttft_s"]
            p = self.hists["tpot_s"]
            q = self.hists["queue_wait_s"]
            occ_mean = self.hists["occupancy"].mean
            out = {
                "occupancy": round(self.occupancy_ewma, 4),
                "occupancy_mean": round(occ_mean, 4),
                "page_util": round(self.page_util_last, 4),
                "page_util_peak": round(self.page_util_peak, 4),
                "run_ahead": self.run_ahead_last,
                "ttft_p50_s": round(t.percentile(50.0), 6),
                "ttft_p95_s": round(t.percentile(95.0), 6),
                "tpot_p50_s": round(p.percentile(50.0), 6),
                "tpot_p95_s": round(p.percentile(95.0), 6),
                "queue_wait_p95_s": round(q.percentile(95.0), 6),
                "attributed_frac": round(self.attributed_frac(), 6),
                "prefill_reuse_frac": round(self.prefill_reuse_frac(), 6),
                "kv_read_pages_per_token": round(
                    self.kv_read_pages_per_token(), 4),
                "shared_prefix_read_frac": round(
                    self.shared_prefix_read_frac(), 6),
            }
        return out

    def snapshot(self, active: int = 0, queued: int = 0) -> dict:
        """The nested ``engine`` view (the rollout server's ``/statusz``
        ``engine`` section)."""
        with self._lock:
            hists = {name: {
                "p50": h.percentile(50.0), "p95": h.percentile(95.0),
                "p99": h.percentile(99.0),
                "max": h.vmax if h.count else 0.0,
                "mean": h.mean, "count": float(h.count),
            } for name, h in self.hists.items() if h.count}
            return {
                "requests": {
                    "active": int(active),
                    "queued": int(queued),
                    "finished": self.requests_finished,
                    "salvaged": self.requests_salvaged,
                    "admitted": self.admitted_requests,
                },
                "tokens": {
                    "req_prefill": self.req_prefill_tokens,
                    "req_decode": self.req_decode_tokens,
                    "sched_prefill": self.sched_prefill_tokens,
                    "sched_decode": self.sched_decode_tokens,
                    "cached_prompt": self.cached_prompt_tokens,
                    "attributed_frac": round(self.attributed_frac(), 6),
                    "prefill_reuse_frac": round(self.prefill_reuse_frac(), 6),
                },
                "occupancy": {
                    "last": round(self.occupancy_last, 4),
                    "ewma": round(self.occupancy_ewma, 4),
                    "pad_frac": round(self.pad_frac_last, 4),
                    "max_slots": self.max_slots,
                },
                "pages": {
                    "util": round(self.page_util_last, 4),
                    "peak_util": round(self.page_util_peak, 4),
                    "cache_pages": self.cache_pages_last,
                    "total": self.num_alloc_pages,
                    # shared-prefix decode attention: HBM reads vs logical
                    "kv_streamed": self.kv_pages_streamed,
                    "kv_logical": self.kv_pages_logical,
                    "kv_read_pages_per_token": round(
                        self.kv_read_pages_per_token(), 4),
                    "shared_prefix_read_frac": round(
                        self.shared_prefix_read_frac(), 6),
                },
                "dispatch": {
                    "decode_dispatches": self.decode_dispatches,
                    "run_ahead": self.run_ahead_last,
                    "idle_iters": self.idle_iters,
                    "admit_waves": self.admit_waves,
                },
                "latency": hists,
            }
