"""RemoteRollout — the trainer-side adapter for disaggregated generation.

A copy of ``polyrl_tpu/rollout/remote.py``. Equivalent of the reference's
C5 ``SGLangRolloutRemote`` + C7 ``StreamingBatchIterator`` (``sglang_rollout_remote.py:227-508``,
``stream_batch_iter.py:19-103``): the trainer hands it the unrolled prompt
batch (n samples per prompt); it streams the batch through the manager's
``/batch_generate_requests`` NDJSON endpoint and yields *complete prompt
groups* as soon as they finish — at least ``min_emit`` trajectories per
yield — so training on early ibatches overlaps generation of later ones
(the streaming overlap that is PolyRL's core idea, SURVEY.md §3.1).

Group integrity: GRPO/RLOO advantages are group-relative, so a group whose
members are split across ibatches would silently normalize against a
partial group. Groups are emitted whole; a group containing a permanently
failed request (manager exhausted its 5 continuation retries) is dropped
with a warning — the trainer's stream accounting tolerates a short batch.

Weight push rides the transfer fabric (C10-C13 equivalents in
``polyrl_tpu_torch.transfer``): ``update_weights`` bumps the manager's weight
version (draining the active pool) and hands the params to the sender
agent, returning the new version.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import random
import threading
import time
from typing import Any, Iterator

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.manager.client import (ControlPlaneDown, GenerateProgress,
                                       GenerateResult, ManagerClient,
                                       ManagerTransportError)
from polyrl_tpu_torch.rollout.pool import BalanceEstimator
from polyrl_tpu_torch.rollout.sampling import SamplingParams

log = logging.getLogger(__name__)


class _SalvageLedger:
    """Per-rid token progress across manager stream attempts (token-level
    continuous generation).

    ``base_*`` — tokens already folded into the re-issued request's prompt
    (the salvaged prefix the target engine prefills instead of re-decoding);
    ``cur_*`` — progress streamed since the last re-issue, folded into base
    on the next failure. The terminal :class:`GenerateResult` of the CURRENT
    request repeats cur's tokens authoritatively, so the stitched sequence
    is always ``base + result`` — never ``base + cur + result``."""

    __slots__ = ("base_t", "base_l", "base_v", "cur_t", "cur_l", "cur_v")

    def __init__(self):
        self.base_t: list[int] = []
        self.base_l: list[float] = []
        self.base_v: list[int] = []
        self.cur_t: list[int] = []
        self.cur_l: list[float] = []
        self.cur_v: list[int] = []

    def extend_cur(self, prog: GenerateProgress) -> None:
        self.cur_t += [int(t) for t in prog.token_ids]
        self.cur_l += [float(x) for x in prog.logprobs]
        self.cur_v += [int(prog.weight_version)] * len(prog.token_ids)

    def fold(self) -> int:
        """Move cur into base (a re-issue is about to carry it in the
        prompt); returns how many tokens were newly salvaged."""
        n = len(self.cur_t)
        self.base_t += self.cur_t
        self.base_l += self.cur_l
        self.base_v += self.cur_v
        self.cur_t, self.cur_l, self.cur_v = [], [], []
        return n

    def stitch(self, res: GenerateResult) -> GenerateResult:
        """Prepend the salvaged prefix to a terminal result."""
        if not self.base_t or not res.success:
            return res
        wvs: list[int] = []
        if self.base_v or res.output_token_weight_versions:
            wvs = self.base_v + (res.output_token_weight_versions
                                 or [-1] * len(res.output_token_ids))
        return dataclasses.replace(
            res,
            output_token_ids=self.base_t + res.output_token_ids,
            output_token_logprobs=self.base_l + res.output_token_logprobs,
            output_token_weight_versions=wvs)


class RemoteRollout:
    def __init__(
        self,
        manager: ManagerClient,
        transfer=None,               # TransferInterface (trainer-side fabric)
        # colocated RolloutServer (time-sliced); no path passes one until
        # the colocated_local hybrid is ported (ROADMAP A' 7)
        local_server=None,
        pad_token_id: int = 0,
        resume_budget: int = 3,      # mid-stream re-issues per batch
        resume_wait_s: float = 60.0,  # per-resume wait for manager recovery
        salvage_partials: bool = True,  # token-level suffix resume
        fault_injector=None,         # rollout/faults.py (tests, chaos drills)
        balance_window: int = 8,     # progressive balance estimator window
        pool=None,                   # rollout/pool.py PoolManager (optional)
    ):
        self.manager = manager
        self.transfer = transfer
        self.local_server = local_server
        self.pad_token_id = pad_token_id
        self.resume_budget = resume_budget
        self.resume_wait_s = resume_wait_s
        self.salvage_partials = salvage_partials
        self.fault_injector = fault_injector
        self.weight_version = 0
        self.last_gen_throughput = 0.0
        self.dropped_groups = 0
        # control-plane fault counters (cumulative; trainer gauges them)
        self.stream_resumes = 0
        self.local_fallbacks = 0
        # requests completed by finish_locally (tier-2 degraded
        # completion): local_fallbacks counts the fallback EVENTS, this
        # counts the request volume those events had to finish on-host —
        # what the degradation plane sizes the cost of tier 2 with
        self.local_fallback_requests = 0
        # token-level salvage counters: tokens carried across a resume
        # instead of re-decoded, suffix re-issues performed, and the prefill
        # length those re-issues paid (prompt + salvage — the recovery cost
        # that replaces full re-decoding)
        self.tokens_salvaged = 0
        self.suffix_resumes = 0
        self.resume_prefill_tokens = 0
        # per-step manager /metrics scrape misses (telemetry degradation is
        # graceful: the merge is skipped, the step never fails — this
        # counter is the only trace a flaky scrape leaves)
        self.scrape_failures = 0
        # sample-looking /metrics lines that failed to parse (torn writes,
        # truncated responses): counted per scrape instead of silently
        # dropped (obs/scrape_partial)
        self.scrape_partials = 0
        # pool re-admissions of the colocated engine that stayed failed
        # past the retry budget: the pool silently lost its local engine
        # (it idles with restored KV HBM while the manager never routes to
        # it) — the counter is the visibility a log line never gave
        self.resume_instances_failures = 0
        # progressive train<->rollout balance estimator: update_metrics
        # feeds the manager's balancer windowed medians instead of the
        # last step's raw scalars (rollout/pool.py)
        self.balance = BalanceEstimator(window=balance_window)
        # optional fleet control plane (rollout/pool.py PoolManager): the
        # trainer merges its pool/* counters and /statusz section
        self.pool = pool
        # per-stream nonce keeps rids globally unique: concurrent streams
        # (nested REMAX baselines, validation overlapping training, and the
        # pipelined trainer's prefetch lane) would otherwise collide on
        # bare indices at the shared engines
        self._stream_seq = itertools.count()
        # time-slice refcount: with the pipelined trainer a validation
        # stream can overlap the prefetch lane's stream — the colocated
        # engine's KV HBM is resumed by the FIRST active stream and
        # released only when the LAST one ends (a per-stream release would
        # yank pages out from under the other stream's requests)
        self._ts_lock = threading.Lock()
        self._ts_active = 0

    def fault_counters(self) -> dict[str, float]:
        """Cumulative control-plane fault metrics (supervisor restarts,
        client retries, stream resumes/fallbacks, dropped groups)."""
        out = {
            "fault/stream_resumes": float(self.stream_resumes),
            "fault/local_fallbacks": float(self.local_fallbacks),
            "fault/local_fallback_requests": float(
                self.local_fallback_requests),
            "fault/dropped_groups": float(self.dropped_groups),
            "fault/tokens_salvaged": float(self.tokens_salvaged),
            "fault/suffix_resumes": float(self.suffix_resumes),
            "fault/resume_prefill_tokens": float(self.resume_prefill_tokens),
            "fault/resume_instances_failed": float(
                self.resume_instances_failures),
            "obs/scrape_failed": float(self.scrape_failures),
            "obs/scrape_partial": float(self.scrape_partials),
        }
        if self.fault_injector is not None:
            # chaos-mode visibility: the injected-fault counters ride the
            # same step-record gauges the recovery counters do, so a drill
            # record shows cause and effect side by side
            out.update(self.fault_injector.counters())
        transfer_counters = getattr(self.transfer, "counters", None)
        if transfer_counters is not None:
            # weight-fabric supervision (transfer/* gauges: push failures/
            # retries, verify rejections, resumed bytes, laggard
            # escalations, the sharded-push plane — push_streams,
            # stream_bw_mbps_min, reshard_bytes, stream_resumes — + knob
            # echo) — rides every step record, which is what the
            # FlightRecorder's transfer/push_failures watch reads
            out.update(transfer_counters())
        retries = getattr(self.manager, "retry_count", None)
        if retries is not None:
            out["fault/client_retries"] = float(retries)
        supervisor = getattr(self.manager, "supervisor", None)
        if supervisor is not None:
            out["fault/manager_restarts"] = float(supervisor.restarts)
        return out

    def _resume_local_instances(self, attempts: int = 3,
                                backoff_base_s: float = 0.1,
                                backoff_max_s: float = 1.0) -> bool:
        """Re-admit the colocated engine to the manager's routing set, with
        a bounded jittered-backoff retry. A one-shot call that swallowed
        its failure used to leave the pool silently one engine short — the
        local engine idled with restored KV HBM while every request went
        remote. Still best-effort past the budget (the stream must start
        even if the manager is mid-respawn), but the failure now lands in
        ``fault/resume_instances_failed`` so it is visible in step records
        instead of only in a log line."""
        err: Exception | None = None
        for attempt in range(attempts):
            try:
                self.manager.resume_local_instances()
                return True
            except Exception as exc:  # noqa: BLE001 — retried below
                err = exc
                if attempt + 1 < attempts:
                    sleep = min(backoff_base_s * 2 ** attempt,
                                backoff_max_s) * (0.5 + random.random())
                    time.sleep(sleep)
        self.resume_instances_failures += 1
        log.error("resume_local_instances failed after %d attempts "
                  "(%d total failures): %s", attempts,
                  self.resume_instances_failures, err)
        return False

    def _wait_manager_recovery(self) -> bool:
        """Poll /health until the manager answers (the supervisor respawn
        lands on a fresh port the client re-resolves) or the resume-wait
        budget expires."""
        deadline = time.monotonic() + self.resume_wait_s
        while time.monotonic() < deadline:
            if self.manager.health():
                return True
            time.sleep(0.25)
        return False

    # -- streaming generation ------------------------------------------------

    def generate_stream(
        self,
        prompt_ids: list[list[int]],
        sampling: SamplingParams,
        group_size: int,
        min_emit: int,
        max_local_gen_s: float | None = None,
        nested: bool = False,
    ) -> Iterator[list[tuple[int, GenerateResult]]]:
        """Yield lists of (original_index, result) covering whole groups,
        ≥ ``min_emit`` entries per yield (except the final remainder).
        Requests ``i*group_size .. (i+1)*group_size-1`` form group ``i``.
        ``min_emit`` need not divide by group_size — emission granularity is
        whole groups, the threshold just gates when to flush.

        ``nested=True`` marks a stream issued while an OUTER stream is still
        active (e.g. REMAX baselines mid-ibatch): it must not touch the
        colocated engine's resume/release lifecycle — release_memory would
        pause the local engine while the outer stream's requests are still
        being served on it."""
        assert len(prompt_ids) % group_size == 0
        # colocated time-slicing: the local engine serves during the window
        # (manager aborts it after max_local_gen_s, handlers.rs:500-513
        # equivalent), then yields its KV HBM back to training. Resume here,
        # release at window expiry (grace for the abort to drain) or at
        # stream end, whichever first.
        local_eng = (self.local_server.engine
                     if self.local_server is not None and not nested else None)
        released = threading.Event()

        def _release() -> None:
            # per-stream idempotent; the engine's KV HBM is only handed
            # back when the LAST concurrent stream releases (refcount)
            if released.is_set() or local_eng is None:
                return
            released.set()
            with self._ts_lock:
                self._ts_active -= 1
                last = self._ts_active == 0
            if not last:
                return
            try:
                local_eng.release_memory()
            except Exception:  # noqa: BLE001 — time-slicing is best-effort
                log.exception("local engine release_memory failed")

        window_timer: threading.Timer | None = None
        if local_eng is not None:
            with self._ts_lock:
                self._ts_active += 1
                first = self._ts_active == 1
            if first and hasattr(local_eng, "resume_memory"):
                local_eng.resume_memory()
            # re-admit time-sliced-out locals to the manager's active pool:
            # the watchdog removed them at the last window expiry
            # (handlers.rs:500-513), and engine resume + pool re-admission
            # must travel together or the pool starves while the engine
            # idles with restored KV HBM.
            self._resume_local_instances()
            if max_local_gen_s:
                window_timer = threading.Timer(max_local_gen_s + 1.0, _release)
                window_timer.daemon = True
                window_timer.start()
        stream_tag = f"s{next(self._stream_seq)}:"
        # group-shared prefill hint: requests i*G..(i+1)*G-1 share a prompt
        # (GRPO's n samples), so each carries a stream-unique group_id +
        # group_size. The manager pins a whole group to ONE engine (its
        # group-affinity routing) and the engine prefills the shared
        # prompt once, batch-attaching the siblings. group_size == 1
        # (validation/REMAX streams) sends no hint.
        reqs = [{"rid": f"{stream_tag}{i}", "input_ids": list(p),
                 **({"group_id": f"{stream_tag}g{i // group_size}",
                     "group_size": group_size} if group_size > 1 else {}),
                 "sampling_params": {
                     "temperature": sampling.temperature,
                     "top_p": sampling.top_p,
                     "top_k": sampling.top_k,
                     "max_new_tokens": sampling.max_new_tokens,
                     "stop_token_ids": list(sampling.stop_token_ids),
                 }}
                for i, p in enumerate(prompt_ids)]

        q: "queue.Queue[Any]" = queue.Queue()
        gen_t0 = time.monotonic()
        # completion timestamp taken in the reader thread: the consumer side
        # only resumes after trainer compute inside each yield, which would
        # inflate elapsed in exactly the overlapped mode this measures
        gen_end = [gen_t0]

        def finish_locally(pending: dict, ledger: dict) -> None:
            # last-resort degrade: the manager stayed down past the resume
            # budget but a colocated engine exists — finish the batch
            # in-process rather than losing it. The engine may have been
            # released by the window timer; resume for the fallback and
            # hand the HBM back afterwards if so. Requests were already
            # folded by fold_salvage, so their input_ids carry the salvaged
            # prefix and their max_new_tokens the remaining budget — the
            # degraded completion also resumes from the last token instead
            # of re-decoding from zero.
            eng = self.local_server.engine
            self.local_fallback_requests += len(pending)
            was_released = released.is_set()
            if hasattr(eng, "resume_memory"):
                eng.resume_memory()
            try:
                # group by remaining budget: eng.generate takes ONE
                # SamplingParams per call, and salvaged requests have
                # per-rid decremented budgets (no salvage → one group,
                # the pre-salvage behavior)
                by_budget: dict[int, list[dict]] = {}
                for r in pending.values():
                    mnt = int(r["sampling_params"].get(
                        "max_new_tokens", sampling.max_new_tokens))
                    by_budget.setdefault(mnt, []).append(r)
                for mnt, items in by_budget.items():
                    sp = dataclasses.replace(sampling, max_new_tokens=mnt)
                    outs = eng.generate([r["input_ids"] for r in items], sp)
                    for r, o in zip(items, outs):
                        if isinstance(o, dict):
                            ids, lps = o["token_ids"], o["logprobs"]
                            reason = o.get("finish_reason", "stop")
                        else:
                            ids = list(o.output_ids)
                            lps = list(o.output_token_logprobs)
                            reason = getattr(o, "finish_reason", "stop")
                        res = GenerateResult(
                            rid=r["rid"], success=reason != "error",
                            output_token_ids=[int(t) for t in ids],
                            output_token_logprobs=[float(x) for x in lps],
                            finish_reason=reason,
                            error="" if reason != "error" else "local fallback")
                        led = ledger.get(r["rid"])
                        q.put(led.stitch(res) if led is not None else res)
            finally:
                if was_released and hasattr(eng, "release_memory"):
                    try:
                        eng.release_memory()
                    except Exception:  # noqa: BLE001 — best-effort handback
                        log.exception("fallback release_memory failed")

        def fold_salvage(pending: dict, ledger: dict) -> None:
            """Token-level salvage after a stream failure: fold each pending
            rid's streamed progress into its request so the re-issue (or the
            local fallback) carries prompt+salvaged as the new prefill —
            hitting the target engine's prefix cache — with the token budget
            decremented. A rid whose salvaged prefix already hit a stop
            token or exhausted its budget is completed right here."""
            stops = set(sampling.stop_token_ids)
            for rid in list(pending):
                led = ledger.get(rid)
                if led is None:
                    continue
                req = pending[rid]
                sp = req["sampling_params"]
                n_new = led.fold()
                if n_new:
                    self.tokens_salvaged += n_new
                    req["input_ids"] = (list(req["input_ids"])
                                        + led.base_t[-n_new:])
                    sp["max_new_tokens"] = int(sp["max_new_tokens"]) - n_new
                if not led.base_t:
                    continue  # nothing salvaged: plain from-zero re-issue
                if led.base_t[-1] in stops or int(sp["max_new_tokens"]) <= 0:
                    # the salvage already completes the request — synthesize
                    # the terminal result instead of re-issuing
                    pending.pop(rid)
                    q.put(GenerateResult(
                        rid=rid, success=True,
                        output_token_ids=list(led.base_t),
                        output_token_logprobs=list(led.base_l),
                        finish_reason=("stop" if led.base_t[-1] in stops
                                       else "length"),
                        output_token_weight_versions=list(led.base_v)))
                    continue
                self.suffix_resumes += 1
                self.resume_prefill_tokens += len(req["input_ids"])

        def run_stream() -> None:
            # drains the NDJSON stream so the manager is never backpressured
            # by training compute (reference stream_batch_iter drain loop).
            # Stream-level resume: a mid-stream transport failure re-issues
            # ONLY the rids without a terminal result yet (completed ones
            # were already queued for group assembly) against the recovered
            # manager, at most resume_budget times. Token-level salvage
            # (salvage_partials): the manager forwards per-token progress
            # lines; a re-issued rid carries prompt+salvaged as its prompt
            # and the stitched result re-decodes NOTHING before the fault.
            pending = {r["rid"]: r for r in reqs}
            ledger: dict[str, _SalvageLedger] = (
                {r["rid"]: _SalvageLedger() for r in reqs}
                if self.salvage_partials else {})
            budget = self.resume_budget
            while pending:
                failure: ManagerTransportError | None = None
                try:
                    stream = self.manager.batch_generate_stream(
                        list(pending.values()),
                        max_local_gen_s=max_local_gen_s)
                    if self.fault_injector is not None:
                        stream = self.fault_injector.wrap_stream(
                            stream, list(pending))
                    for res in stream:
                        if isinstance(res, GenerateProgress):
                            led = ledger.get(res.rid)
                            if led is not None and res.rid in pending:
                                led.extend_cur(res)
                            continue
                        pending.pop(res.rid, None)
                        led = ledger.get(res.rid)
                        q.put(led.stitch(res) if led is not None else res)
                except ManagerTransportError as exc:
                    failure = exc
                if not pending:
                    return  # every rid got a terminal result
                if failure is None:
                    # the manager answers EVERY rid before ending the
                    # stream, so a "clean" end with rids missing is a
                    # truncated stream: a SIGKILLed manager closes the
                    # socket at a chunk boundary, which http.client reads
                    # as EOF, not as an error
                    failure = ManagerTransportError(
                        f"stream ended with {len(pending)} rids unanswered")
                if self.salvage_partials:
                    fold_salvage(pending, ledger)
                    if not pending:
                        return  # salvage completed every remaining rid
                log.warning(
                    "manager stream failed with %d/%d rids pending (%s); "
                    "attempting resume (%d left in budget)",
                    len(pending), len(reqs), failure, budget)
                recovered = False
                if budget > 0:
                    # recovery wait is attributable stall time: the goodput
                    # ledger maps the rollout/resume_wait_s totals into the
                    # salvage_resume phase
                    t_rw = time.monotonic()
                    recovered = self._wait_manager_recovery()
                    obs.observe("rollout/resume_wait_s",
                                time.monotonic() - t_rw)
                if recovered:
                    budget -= 1
                    self.stream_resumes += 1
                    continue
                if self.local_server is not None:
                    self.local_fallbacks += 1
                    log.warning("control plane down; finishing %d requests "
                                "on the colocated engine", len(pending))
                    finish_locally(pending, ledger)
                    return
                raise ControlPlaneDown(
                    f"manager unreachable after {self.resume_budget} stream "
                    f"resumes; {len(pending)} requests outstanding"
                ) from failure

        # trace hand-off: the reader drains in its own thread, so the span
        # context active HERE (the trainer's step span) is captured and
        # adopted there — the stream and its manager calls nest under the
        # step instead of starting orphan traces
        trace_ctx = obs.get_tracer().capture()

        def reader() -> None:
            try:
                with obs.get_tracer().adopt(trace_ctx), \
                        obs.span("rollout/stream", n=len(reqs)):
                    run_stream()
                gen_end[0] = time.monotonic()
                q.put(None)
            except Exception as exc:  # noqa: BLE001
                gen_end[0] = time.monotonic()
                q.put(exc)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        n_tokens = 0

        groups: dict[int, list[tuple[int, GenerateResult]]] = {}
        failed_groups: set[int] = set()
        seen_rids: set[str] = set()
        pending: list[tuple[int, GenerateResult]] = []
        # try/finally: if the consumer abandons the generator or the stream
        # raises, the window timer must die and the colocated engine's KV
        # pool must still be handed back to training — leaking either starves
        # the trainer of HBM for the rest of the run.
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                res: GenerateResult = item
                if res.rid in seen_rids:
                    # exactly-once guard across stream resumes: a result
                    # delivered just before the transport failure must not
                    # be double-counted if a re-issue races it
                    continue
                seen_rids.add(res.rid)
                idx = int(res.rid.rsplit(":", 1)[-1])
                g = idx // group_size
                if g in failed_groups:
                    continue
                if not res.success:
                    log.warning("group %d dropped: request %d failed: %s",
                                g, idx, res.error)
                    failed_groups.add(g)
                    groups.pop(g, None)
                    self.dropped_groups += 1
                    continue
                # per-request distribution telemetry (trainer-side view):
                # time from batch submission to this result, and the
                # request's effective decode rate over that window — the
                # tail the balancer reacts to, invisible in step averages
                lat = time.monotonic() - gen_t0
                obs.observe("rollout/latency_s", lat)
                if res.output_token_ids and lat > 0:
                    obs.observe("rollout/decode_tok_s",
                                len(res.output_token_ids) / lat)
                n_tokens += len(res.output_token_ids)
                groups.setdefault(g, []).append((idx, res))
                if len(groups[g]) == group_size:
                    pending.extend(sorted(groups.pop(g)))
                    if len(pending) >= min_emit:
                        yield pending
                        pending = []
            if groups:  # stream ended with incomplete groups (should not happen)
                log.warning("%d groups incomplete at stream end", len(groups))
                self.dropped_groups += len(groups)
            elapsed = gen_end[0] - gen_t0
            self.last_gen_throughput = n_tokens / elapsed if elapsed > 0 else 0.0
            if pending:
                yield pending
        finally:
            if window_timer is not None:
                window_timer.cancel()
            _release()  # stream done/abandoned: nothing left to serve locally

    # -- weight + metrics plane ----------------------------------------------

    def update_weights(self, params: Any, version: int | None = None) -> int:
        """Push new weights to every rollout instance through the fabric
        (§3.3 end-to-end). Falls back to a bare version bump when no fabric
        is attached (pure local serving)."""
        if self.transfer is not None:
            self.weight_version = self.transfer.update_weights_with_agent(params)
        else:
            self.weight_version = self.manager.update_weight_version()
        self._update_local_copy(params)
        return self.weight_version

    def update_weights_async(self, params: Any) -> int:
        """Non-blocking flavor for the pipelined trainer: the manager
        version bump (pool drain) and the colocated-engine copy happen
        inline — both are cheap and/or device work that belongs on the
        trainer thread — while the fabric's pack/wire round completes in
        the background. ``wait_pushed()`` is the fence. Falls back to the
        synchronous push when no async-capable fabric is attached."""
        if self.transfer is None or not hasattr(self.transfer,
                                                "update_weights_async"):
            return self.update_weights(params)
        self.weight_version = self.transfer.update_weights_async(params)
        self._update_local_copy(params)
        return self.weight_version

    def wait_pushed(self, timeout: float = 600.0) -> None:
        """Block until every queued async push's pack round has landed;
        re-raises a background push failure. No-op with no fabric."""
        if self.transfer is not None and hasattr(self.transfer,
                                                 "wait_pushed"):
            self.transfer.wait_pushed(timeout)

    def push_lag(self) -> int:
        """Async push rounds issued but not yet landed on the fabric —
        the pipelined trainer's ``perf/staleness_lag`` gauge feed."""
        fn = getattr(self.transfer, "push_lag", None)
        return int(fn()) if fn is not None else 0

    def wait_push_lag(self, max_lag: int, timeout: float = 600.0) -> None:
        """Bounded-staleness admission gate (``trainer.staleness_limit``):
        block until at most ``max_lag`` pushes are in flight. Falls back
        to the full fence on fabrics without the lag surface."""
        fn = getattr(self.transfer, "wait_push_lag", None)
        if fn is not None:
            fn(max_lag, timeout)
        else:
            self.wait_pushed(timeout)

    def _update_local_copy(self, params: Any) -> None:
        if self.local_server is None:
            return
        # the colocated engine copies the tree into its own tensors in
        # place (CBEngine.update_weights), so the actor's next optimizer
        # step cannot change what it serves; no fabric hop, and the
        # manager re-adds locals to the pool on update_weight_version
        self.local_server.engine.update_weights(params,
                                                version=self.weight_version)

    def scrape_manager_metrics(self) -> dict[str, float]:
        """One scrape of the manager's GET /metrics, as ``manager/*`` gauge
        keys for the step record. Best-effort: a scrape miss (manager
        respawning, stub manager in tests) returns {}. Each scrape's wall
        latency lands in the ``manager/scrape_s`` histogram (a slow scrape
        on the pipeline lane delays the next stream's admission) and
        partially-parseable lines count into ``obs/scrape_partial``."""
        metrics_text = getattr(self.manager, "metrics_text", None)
        if metrics_text is None:
            return {}
        try:
            t0 = time.monotonic()
            gauges, partials = obs.manager_gauges_partial(metrics_text())
            obs.observe("manager/scrape_s", time.monotonic() - t0)
            self.scrape_partials += partials
            return gauges
        except Exception:  # noqa: BLE001 — telemetry must not fail a step
            # skip the merge, count the miss (obs/scrape_failed gauge via
            # fault_counters) — a respawning/flaky manager degrades the
            # step record, never the step or the pipeline lane
            self.scrape_failures += 1
            log.warning("manager /metrics scrape failed (%d total)",
                        self.scrape_failures, exc_info=True)
            return {}

    def update_metrics(self, **stats) -> dict:
        """Feed step stats to the manager's adaptive balancer; returns its
        response incl. the next local-generation budget (handlers.rs:867-901
        equivalent).

        The raw per-step stats first fold into the progressive balance
        estimator (``generate_s``/``update_s`` goodput phase walls ride
        along and stay trainer-side); the manager then receives the
        windowed medians — one anomalous step no longer swings the
        colocated generation window by gap/3."""
        self.balance.observe(**stats)
        smoothed = dict(stats)
        # estimator-only inputs never reach the wire
        smoothed.pop("generate_s", None)
        smoothed.pop("update_s", None)
        smoothed.pop("occupancy", None)
        smoothed.pop("device_frac", None)
        smoothed.update(self.balance.stats())
        try:
            return self.manager.update_metrics(**smoothed)
        except Exception:  # noqa: BLE001 — metrics are best-effort
            log.exception("update_metrics failed")
            return {}
