"""Goodput accounting: decompose each training step's wall time into an
exhaustive, non-overlapping phase taxonomy (a copy of
``polyrl_tpu/obs/goodput.py``, less its double count; see ``bubble``).

The ledger consumes what the step
already measures (``marked_timer`` phase timings, the stream-wait bubble,
the pipeline overlap credit, the obs histogram registry) and emits
``goodput/*`` step metrics whose phase keys sum to the measured wall step
time by construction (the residual lands in ``goodput/other_s``), plus
tokens-per-chip-second and a model-FLOPs MFU estimate
(:mod:`polyrl_tpu_torch.utils.flops` over the ``models/decoder.py`` shapes,
against the H100's bf16 peak).

Phase taxonomy (seconds, non-overlapping, sum = ``goodput/step_wall_s``):

- ``generate``  — in-loop (colocated) generation (``timing_s/gen``)
- ``bubble``    — blocked waiting on rollout arrival, NET of the compute
  phases that run inside the wait (colocated gen + multi-host broadcast
  happen inside ``next(ibatch)`` and would double-count otherwise) and
  NET of the ``manager/rtt_s`` round trips that fell inside the wait
  (``rtt_in_bubble_s``: the remote stream's manager calls run while the
  trainer waits on it, and the ``manager_rtt`` phase counts them once).
  The reference counts those twice (its ``attributed_frac`` reads above
  1 on disaggregated steps); this is the one difference kept, with its
  twin below.
- ``process``   — reward / old+ref logprob / values / advantage / broadcast
- ``update``    — actor + critic fwd/bwd and optimizer steps
- ``weight_push`` — weight sync (``update_weight`` + the pipelined
  ``prefetch_fence``)
- ``salvage_resume`` — stream-resume recovery waits
  (``rollout/resume_wait_s`` observations)
- ``manager_rtt``  — manager control-plane round trips outside streaming
  (``manager/rtt_s`` observations), less ``rtt_elsewhere_s``: the round
  trips before the step began (the bootstrap push's) and inside the
  weight push, which ``weight_push`` already holds
- ``housekeeping`` — validation + checkpoint IO
- ``other``     — the unattributed residual (clamped at 0)

``goodput/overlap_credit_s`` (pipelined generation that happened before
the step began) is informational and deliberately NOT part of the sum —
it is time saved, not time spent.
"""

from __future__ import annotations

import threading

PHASES = ("generate", "bubble", "process", "update", "weight_push",
          "salvage_resume", "manager_rtt", "housekeeping", "other")

# marked_timer key -> phase. Keys absent here are still covered: they are
# inside the wall, so the residual ("other") absorbs them.
TIMING_PHASE = {
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
    "update_weight": "weight_push",
    "prefetch_fence": "weight_push",
    "testing": "housekeeping",
    "save_checkpoint": "housekeeping",
    # the autoscaling controller's tick: with a step-paced spot market a
    # preemption notice drains its engine there, on the trainer's thread
    # (the reference leaves it to ``other``)
    "autoscale": "housekeeping",
}
# phases that execute INSIDE the ibatch wait (the bubble measures blocked
# time on next(ibatch); colocated generation and the multi-host broadcast
# run within that wait, so the bubble is netted down by their time)
_INSIDE_BUBBLE = ("gen", "broadcast")
# histogram-registry series whose per-step TOTAL is a phase
HIST_PHASE = {
    "rollout/resume_wait_s": "salvage_resume",
    "manager/rtt_s": "manager_rtt",
}


class GoodputLedger:
    """Per-step attribution ledger + cumulative run totals (the /statusz
    snapshot reads the cumulative side). Thread-safe: the statusz exporter
    snapshots from its own HTTP thread while the fit loop accounts."""

    def __init__(self, flops=None):
        # optional utils.flops.FlopsCounter for the MFU estimate
        self.flops = flops
        self.steps = 0
        self.cum = {p: 0.0 for p in PHASES}
        self.cum_wall = 0.0
        self.cum_overlap = 0.0
        self.cum_tokens = 0
        self.last: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- per-step attribution ------------------------------------------------

    def account(self, *, step_time_s: float, timings: dict | None = None,
                bubble_s: float = 0.0, overlap_s: float = 0.0,
                histograms: dict | None = None, n_tokens: int = 0,
                mean_context_len: float = 0.0, n_chips: int = 1,
                rtt_in_bubble_s: float = 0.0,
                rtt_elsewhere_s: float = 0.0) -> dict[str, float]:
        """Attribute one step; returns the ``goodput/*`` metric dict.

        ``timings`` is the tracker's ``timing_s`` map (seconds per
        marked_timer key); ``histograms`` the step's drained obs registry
        (``{name: Histogram}`` — totals of the HIST_PHASE series become
        their phases). ``step_time_s`` is the FULL wall including
        validation/checkpoint, so housekeeping is attributable.
        ``rtt_in_bubble_s`` is the part of the ``manager/rtt_s`` total
        observed while the trainer waited on the stream: it is netted out
        of ``bubble`` (at most the bubble itself), since ``manager_rtt``
        counts it; ``rtt_elsewhere_s`` is the part that another phase
        already holds or that predates the step, kept out of
        ``manager_rtt``."""
        timings = timings or {}
        phases = {p: 0.0 for p in PHASES}
        for key, secs in timings.items():
            phase = TIMING_PHASE.get(key)
            if phase is not None:
                phases[phase] += float(secs)
        inside = sum(float(timings.get(k, 0.0)) for k in _INSIDE_BUBBLE)
        phases["bubble"] = max(
            0.0, float(bubble_s) - inside - float(rtt_in_bubble_s))
        for name, hist in (histograms or {}).items():
            phase = HIST_PHASE.get(name)
            if phase is not None:
                phases[phase] += float(hist.total)
        phases["manager_rtt"] = max(
            0.0, phases["manager_rtt"] - float(rtt_elsewhere_s))
        attributed = sum(phases.values())
        phases["other"] = max(0.0, float(step_time_s) - attributed)

        wall = max(float(step_time_s), 1e-9)
        out = {f"goodput/{p}_s": v for p, v in phases.items()}
        out["goodput/step_wall_s"] = float(step_time_s)
        out["goodput/overlap_credit_s"] = float(overlap_s)
        # fraction of the wall the named (non-residual) phases explain —
        # >1 means double-counted attribution, the bug the pinning test
        # exists to catch
        out["goodput/attributed_frac"] = attributed / wall
        out["goodput/productive_frac"] = (
            phases["generate"] + phases["process"] + phases["update"]) / wall
        if n_tokens:
            out["goodput/tok_s_per_chip"] = (
                n_tokens / wall / max(int(n_chips), 1))
        if self.flops is not None and n_tokens:
            # goodput/{tflops_all_chips,tflops_per_chip,mfu} from the model
            # flops decomposition (utils/flops.py over decoder shapes)
            out.update(self.flops.step_metrics(
                n_tokens, mean_context_len, float(step_time_s),
                prefix="goodput"))
        with self._lock:
            self.steps += 1
            for p, v in phases.items():
                self.cum[p] += v
            self.cum_wall += float(step_time_s)
            self.cum_overlap += float(overlap_s)
            self.cum_tokens += int(n_tokens)
            self.last = dict(out)
        return out

    # -- cumulative view (the /statusz goodput block) ------------------------

    def snapshot(self) -> dict:
        with self._lock:
            cum = dict(self.cum)
            return {
                "steps": self.steps,
                "wall_s": round(self.cum_wall, 3),
                "tokens": self.cum_tokens,
                "overlap_credit_s": round(self.cum_overlap, 3),
                "phase_s": {p: round(v, 3) for p, v in cum.items()},
                "phase_frac": {
                    p: round(v / self.cum_wall, 4) if self.cum_wall else 0.0
                    for p, v in cum.items()},
                "last": dict(self.last),
            }
