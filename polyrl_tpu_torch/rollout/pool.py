"""Elastic rollout pool: N engines, one manager, preemption as a normal
event (a copy of ``polyrl_tpu/rollout/pool.py``).

The C++ manager owns the data plane — request routing (queue-depth- and
weight-version-aware, ``state.h next_instance``), heartbeat-timeout
eviction, and the weight-bootstrap gate that keeps a late joiner out of
the routing set until its weight version reaches the pool floor. This
module is the FLEET-side control plane on top of it:

- :class:`PoolManager` — membership lifecycle. ``add_engine`` registers a
  server (attaching its weight receiver so the transfer fabric's idle poll
  catches it up to the current version), ``preempt`` runs the scale-down
  drill (``POST /drain`` → salvaged partials re-route as suffix resumes on
  survivors → graceful deregistration), and ``sweep``/``wait_for_size``
  give tests, the bench ``--pool`` topology, and the trainer's /statusz a
  live membership view with ``pool/*`` counters.
- :class:`BalanceEstimator` — the paper's progressive train↔rollout
  balance estimator: a sliding window over recent steps' ``goodput/*``
  phase walls (generate vs update vs bubble) replaces the one-scalar feed
  the manager's hill-climbing balancer used to get, so one anomalous step
  (a preemption drill, a checkpoint) no longer yanks the colocated
  generation window around.

Scheduling reference: the Adaptive Placement framework (PAPERS.md);
trainer/fleet decoupling per LlamaRL (PAPERS.md).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.request
from collections import deque
from statistics import median

from polyrl_tpu_torch.obs.timeseries import least_squares_slope

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PoolConfig:
    """``rollout.pool.*`` knobs (config.py RolloutSection)."""
    # expected pool size for launchers/bench --pool (0 = whatever joins)
    engines: int = 0
    # background membership sweep cadence (0 = manual sweep() only)
    sweep_interval_s: float = 0.0
    # scale-down drill: wait after /drain for abort partials to flush
    # through their open manager streams before deregistering
    drain_grace_s: float = 0.5
    # scale-up: how long add_engine(wait=True) waits for the engine to
    # pass health + the weight-bootstrap gate into the routing set
    join_deadline_s: float = 120.0
    # balance estimator sliding window (steps)
    balance_window: int = 8


def _http_post(endpoint: str, path: str, payload: dict | None = None,
               timeout: float = 5.0) -> dict:
    req = urllib.request.Request(
        f"http://{endpoint}{path}",
        data=json.dumps(payload or {}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


def _http_get(endpoint: str, path: str, timeout: float = 3.0) -> dict:
    req = urllib.request.Request(f"http://{endpoint}{path}", method="GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


class PoolManager:
    """Fleet membership on top of a :class:`ManagerClient`.

    The manager's registry is the source of truth; this object adds the
    lifecycle verbs (join with weight catch-up, preemption drill, hard
    evict), a cached membership snapshot for /statusz, and cumulative
    ``pool/*`` counters for step records."""

    def __init__(self, manager, cfg: PoolConfig | None = None):
        self.manager = manager
        self.cfg = cfg or PoolConfig()
        self._lock = threading.Lock()
        self._last_status: dict = {}
        self._last_sweep = 0.0
        # drill bookkeeping (manager counters survive respawns via
        # /reconcile; these are the drills THIS control plane initiated)
        self.preemptions = 0
        self.hard_evictions = 0
        # weight-fabric escalations: engines drained + deregistered after exhausting
        # their push retry budget — dead capacity removed, not re-pushed
        self.laggards = 0
        # optional zero-arg callable returning the sender-side per-engine
        # sync health ({endpoint: {pushed_version, push_failures, ...}};
        # train.py wires TransferInterface.sync_health) — merged into the
        # /statusz pool section's engine rows as their "transfer" block
        self.transfer_health_fn = None
        # sweep fault isolation: transient manager HTTP errors are
        # counted (pool/sweep_failed) and backed off, never fatal to the
        # background sweep thread
        self.sweep_failures = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.cfg.sweep_interval_s > 0:
            self._thread = threading.Thread(target=self._sweep_loop,
                                            name="pool-sweep", daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- membership view ---------------------------------------------------

    def sweep(self) -> dict:
        """One /get_instances_status snapshot (cached for statusz readers);
        best-effort — a respawning manager returns the last good view."""
        try:
            st = self.manager.get_instances_status()
        except Exception:  # noqa: BLE001 — manager mid-respawn
            self.sweep_failures += 1
            log.warning("pool sweep failed; serving last snapshot",
                        exc_info=True)
            with self._lock:
                return dict(self._last_status)
        with self._lock:
            self._last_status = st
            self._last_sweep = time.monotonic()
        return st

    def _sweep_loop(self) -> None:
        # fault isolation: sweep() already swallows manager errors, but a
        # flaky manager must not spin the thread at full cadence either —
        # consecutive failures double the interval (capped at 8x), one
        # success restores it, and the loop NEVER exits on error
        base = self.cfg.sweep_interval_s
        interval = base
        while not self._stop.wait(interval):
            before = self.sweep_failures
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — belt and braces: nothing
                # a sweep raises may kill the membership view
                self.sweep_failures += 1
                log.warning("pool sweep raised; continuing", exc_info=True)
            interval = (min(interval * 2, base * 8)
                        if self.sweep_failures > before else base)

    def engines(self, refresh: bool = True) -> list[dict]:
        st = self.sweep() if refresh else self._last_status
        return list(st.get("instances", []))

    def active_count(self, refresh: bool = True) -> int:
        return sum(1 for i in self.engines(refresh)
                   if i.get("active", i.get("healthy")))

    def probe(self, endpoint: str) -> bool:
        """Direct serving-health probe of one engine (the manager's view
        lags one heartbeat tick; drills want the live answer)."""
        try:
            return _http_get(endpoint, "/health_generate").get(
                "status") == "ok"
        except Exception:  # noqa: BLE001 — dead/draining engines say no
            return False

    # -- scale-up ----------------------------------------------------------

    def add_engine(self, server=None, endpoint: str = "",
                   transfer_streams: int = 4, wait: bool = True,
                   deadline_s: float | None = None) -> str:
        """Join one engine mid-run. With a :class:`RolloutServer`, the
        weight receiver is attached too, so the transfer fabric's idle
        poll full-pushes the current version and the engine then rides the
        normal async push fan-out; the manager keeps it OUT of the routing
        set until its version reaches the pool floor (state.h
        promote_healthy / complete_weight_update). Returns the endpoint."""
        if server is not None:
            from polyrl_tpu_torch.rollout.serve import register_with_manager

            register_with_manager(server, client=self.manager,
                                  transfer_streams=transfer_streams)
            endpoint = server.endpoint
        elif endpoint:
            self.manager.register_rollout_instance(endpoint)
        else:
            raise ValueError("add_engine needs a server or an endpoint")
        if wait:
            self.wait_for_member(endpoint,
                                 deadline_s or self.cfg.join_deadline_s)
        return endpoint

    def wait_for_member(self, endpoint: str, deadline_s: float = 120.0,
                        active: bool = True) -> dict:
        """Poll until ``endpoint`` is in the routing set (or merely
        registered+healthy with ``active=False``)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            for inst in self.engines():
                if inst.get("endpoint") != endpoint:
                    continue
                if inst.get("active") if active else inst.get("healthy"):
                    return inst
            time.sleep(0.1)
        raise TimeoutError(
            f"engine {endpoint} not {'active' if active else 'healthy'} "
            f"after {deadline_s:.0f}s: {self.engines(refresh=False)}")

    def wait_for_size(self, n: int, deadline_s: float = 60.0) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < deadline_s:
            if self.active_count() >= n:
                return
            time.sleep(0.1)
        raise TimeoutError(f"pool never reached {n} active engines: "
                           f"{self.engines(refresh=False)}")

    # -- scale-down --------------------------------------------------------

    def preempt(self, endpoint: str, grace_s: float | None = None) -> dict:
        """Scale-down as a drill, not a disaster: ``POST /drain`` (the
        engine refuses new admissions and aborts in-flight requests into
        salvageable partials, which re-route to survivors as suffix
        resumes through the manager's continuation), a short grace for
        those aborts to flush, then graceful deregistration.

        Against an ALREADY-DEAD endpoint the drain POST fails: there are
        no partials to flush, so the grace sleep is skipped and the
        removal falls through to the hard-eviction path idempotently —
        booked ONCE as an eviction (not a graceful departure), never a
        raise (the heartbeat backstops a failed deregister too)."""
        self.preemptions += 1
        out: dict = {}
        drained = True
        try:
            out = _http_post(endpoint, "/drain")
        except Exception:  # noqa: BLE001 — engine may already be gone
            drained = False
            log.warning("drain of %s failed; evicting instead",
                        endpoint, exc_info=True)
        if not drained:
            self.hard_evictions += 1
            try:
                self.manager.deregister_rollout_instance(endpoint,
                                                         drained=False)
            except Exception:  # noqa: BLE001 — heartbeat backstops
                log.warning("eviction of %s failed; heartbeat will evict",
                            endpoint, exc_info=True)
            return out
        time.sleep(grace_s if grace_s is not None else self.cfg.drain_grace_s)
        try:
            self.manager.deregister_rollout_instance(endpoint, drained=True)
        except Exception:  # noqa: BLE001 — heartbeat eviction backstops
            log.warning("deregister of %s failed; heartbeat will evict",
                        endpoint, exc_info=True)
        return out

    def evict(self, endpoint: str) -> None:
        """Hard removal (the drill for death WITHOUT notice — normally the
        manager's heartbeat does this on its own)."""
        self.hard_evictions += 1
        self.manager.deregister_rollout_instance(endpoint, drained=False)

    def escalate_laggard(self, endpoint: str, reason: str = "") -> None:
        """Weight-fabric escalation (``SenderAgent.laggard_cb``): this
        engine exhausted its push retry budget — its weights can never
        catch up, the bootstrap gate already holds it out of routing, and
        until now it was re-pushed every ``poll_s`` forever. Drain it
        (best-effort: salvageable partials re-route to survivors) and
        deregister, booking an eviction — it is dead capacity, not a
        graceful departure."""
        self.laggards += 1
        log.error("pool: escalating laggard %s (%s) — drain + deregister",
                  endpoint, reason or "push retry budget exhausted")
        try:
            _http_post(endpoint, "/drain")
        except Exception:  # noqa: BLE001 — it may be fully dead already
            log.warning("laggard drain of %s failed; deregistering anyway",
                        endpoint, exc_info=True)
        try:
            self.manager.deregister_rollout_instance(endpoint,
                                                     drained=False)
        except Exception:  # noqa: BLE001 — heartbeat eviction backstops
            log.warning("laggard deregister of %s failed; heartbeat will "
                        "evict", endpoint, exc_info=True)

    # -- telemetry ---------------------------------------------------------

    def counters(self, refresh: bool = True) -> dict[str, float]:
        """``pool/*`` + fleet ``engine/*`` gauges for step records / bench
        lines. The engine gauges aggregate the flight-deck telemetry the
        manager's stats poller forwards per instance: mean + min decode
        occupancy (a collapse on ONE engine must be visible in the fleet
        view), worst page-pool pressure, worst latency tails, summed
        throughput — the step-record feed the FlightRecorder watches."""
        st = self.sweep() if refresh else dict(self._last_status)
        pool = st.get("pool", {})
        insts = st.get("instances", [])
        out = {
            "pool/engines": float(pool.get("registered", len(insts))),
            "pool/active": float(pool.get("active", 0)),
            "pool/pending": float(pool.get("pending", 0)),
            "pool/joins": float(pool.get("joins", 0)),
            "pool/evictions": float(pool.get("evictions", 0)),
            "pool/drain_departures": float(pool.get("drain_departures", 0)),
            "pool/preemption_drills": float(self.preemptions),
            "pool/laggard_escalations": float(self.laggards),
            "pool/sweep_failed": float(self.sweep_failures),
        }
        versions = [int(i.get("weight_version", -1)) for i in insts]
        if versions:
            out["pool/weight_version_floor"] = float(min(versions))
        out.update(self._fleet_engine_gauges(insts))
        return out

    @staticmethod
    def _fleet_engine_gauges(insts: list[dict]) -> dict[str, float]:
        """Fleet-wide ``engine/*`` aggregates over the instances reporting
        flight-deck telemetry (engines predating it are skipped, not
        counted as zeros — a joining v0 engine must not fake a collapse)."""
        rep = [i for i in insts
               if i.get("healthy") and "occupancy" in i]
        if not rep:
            return {}
        occ = [float(i.get("occupancy", 0.0)) for i in rep]
        out = {
            "engine/occupancy": sum(occ) / len(occ),
            "engine/occupancy_min": min(occ),
            "engine/page_util": max(float(i.get("page_util", 0.0))
                                    for i in rep),
            "engine/ttft_p95_s": max(float(i.get("ttft_p95_s", 0.0))
                                     for i in rep),
            "engine/tpot_p95_s": max(float(i.get("tpot_p95_s", 0.0))
                                     for i in rep),
            "engine/cache_hit_rate": (
                sum(float(i.get("cache_hit_rate", 0.0)) for i in rep)
                / len(rep)),
            "engine/throughput_tok_s": sum(
                float(i.get("last_gen_throughput", 0.0)) for i in rep),
            "engine/attributed_frac_min": min(
                float(i.get("attributed_frac", 1.0)) for i in rep),
            # group-shared prefill: fleet-mean fraction of prompt tokens
            # served from shared/cached pages, and the request-level
            # (length-unbiased) prefix hit fraction
            "engine/prefill_reuse_frac": (
                sum(float(i.get("prefill_reuse_frac", 0.0)) for i in rep)
                / len(rep)),
            "engine/prefix_hit_frac": (
                sum(float(i.get("prefix_hit_frac", 0.0)) for i in rep)
                / len(rep)),
            # shared-prefix decode attention: fleet-mean HBM pages streamed
            # per decoded token and the fraction of logical KV reads the
            # grouped kernel deduplicated (the decode-bandwidth A/B signal)
            "engine/kv_read_pages_per_token": (
                sum(float(i.get("kv_read_pages_per_token", 0.0))
                    for i in rep) / len(rep)),
            "engine/shared_prefix_read_frac": (
                sum(float(i.get("shared_prefix_read_frac", 0.0))
                    for i in rep) / len(rep)),
        }
        # KV memory plane (rollout/kvledger.py) — worst-case semantics:
        # the coldest engine is the one the spill/autoscale tiers act on,
        # the tightest HBM headroom is the one that OOMs first. Per-field
        # presence guard: engines with the ledger off (or predating it)
        # are skipped, not counted as 0 cold / 0 headroom.
        cold = [float(i["kv_cold_page_frac"]) for i in rep
                if "kv_cold_page_frac" in i]
        if cold:
            out["engine/kv_cold_page_frac"] = max(cold)
        heads = [float(i["hbm_headroom_gb"]) for i in rep
                 if "hbm_headroom_gb" in i]
        if heads:
            out["engine/hbm_headroom_gb"] = min(heads)
        # host-RAM spill tier (rollout/kvspill.py) — worst case again: the
        # engine with the most KV paged out (frac can exceed 1.0 under
        # oversubscription) and the hottest restore churn (thrash signal)
        spilled = [float(i["kv_spilled_frac"]) for i in rep
                   if "kv_spilled_frac" in i]
        if spilled:
            out["engine/kv_spilled_frac"] = max(spilled)
        restores = [float(i["kv_restore_rate"]) for i in rep
                    if "kv_restore_rate" in i]
        if restores:
            out["engine/kv_restore_rate"] = max(restores)
        # engine-loop profiler (obs/engine_profile.py) — the fleet's
        # weakest link again: the LOWEST device_frac is the engine whose
        # loop thread is burning the most host wall per device second
        # (the disaggregation steering signal), the HIGHEST
        # accounting_frac the first to trip the overhead budget. Presence
        # guard: engines with loop_profile off (or predating it) are
        # skipped, not counted as 0.
        device = [float(i["device_frac"]) for i in rep
                  if "device_frac" in i]
        if device:
            out["engine/device_frac"] = min(device)
        acct = [float(i["accounting_frac"]) for i in rep
                if "accounting_frac" in i]
        if acct:
            out["engine/accounting_frac"] = max(acct)
        host = [float(i["host_overhead_frac"]) for i in rep
                if "host_overhead_frac" in i]
        if host:
            out["engine/host_overhead_frac"] = max(host)
        return out

    def engine_section(self) -> dict:
        """The trainer-side /statusz ``engine`` block: the fleet aggregate
        plus the per-engine flight-deck view (served from the cached sweep
        — the exporter never blocks on a respawning manager). Since v8 it
        carries the ``loop`` block (the fleet view of the engine-loop
        profiler) like the rollout plane does."""
        with self._lock:
            insts = list(dict(self._last_status).get("instances", []))
        fleet = {k.split("/", 1)[1]: round(v, 6)
                 for k, v in self._fleet_engine_gauges(insts).items()}
        return {
            "fleet": fleet,
            "engines": [{
                "endpoint": i.get("endpoint", ""),
                "occupancy": float(i.get("occupancy", 0.0)),
                "page_util": float(i.get("page_util", 0.0)),
                "ttft_p95_s": float(i.get("ttft_p95_s", 0.0)),
                "tpot_p95_s": float(i.get("tpot_p95_s", 0.0)),
                "cache_hit_rate": float(i.get("cache_hit_rate", 0.0)),
                "spec_accept_rate": float(i.get("spec_accept_rate", 0.0)),
                "attributed_frac": float(i.get("attributed_frac", 1.0)),
                "prefill_reuse_frac": float(
                    i.get("prefill_reuse_frac", 0.0)),
                "kv_read_pages_per_token": float(
                    i.get("kv_read_pages_per_token", 0.0)),
                "shared_prefix_read_frac": float(
                    i.get("shared_prefix_read_frac", 0.0)),
                "throughput_tok_s": float(i.get("last_gen_throughput", 0.0)),
                "kv_cold_page_frac": float(i.get("kv_cold_page_frac", 0.0)),
                # engine-loop profiler split (presence-guarded: the
                # manager only forwards them when the engine reports)
                **({"device_frac": float(i["device_frac"])}
                   if "device_frac" in i else {}),
                **({"accounting_frac": float(i["accounting_frac"])}
                   if "accounting_frac" in i else {}),
                "running": int(i.get("num_running_reqs", 0)),
            } for i in insts if "occupancy" in i],
            "loop": self.loop_profile_section(),
        }

    def loop_profile_section(self) -> dict:
        """The fleet view of the engine-loop profiler (statusz v8
        ``engine.loop`` on the trainer plane, and the FlightRecorder's
        ``engine_profile_fn`` → ``engine_profile.json`` bundle artifact):
        worst-case device/accounting split + the per-engine rows, served
        from the cached sweep. ``{"enabled": false}`` when no engine
        reports the profiler fields (loop_profile off fleet-wide, or
        engines predating it)."""
        with self._lock:
            insts = list(dict(self._last_status).get("instances", []))
        rep = [i for i in insts
               if i.get("healthy") and "device_frac" in i]
        if not rep:
            return {"enabled": False}
        return {
            "enabled": True,
            "engines_reporting": len(rep),
            "device_frac_min": round(
                min(float(i["device_frac"]) for i in rep), 6),
            "accounting_frac_max": round(
                max(float(i.get("accounting_frac", 0.0)) for i in rep), 6),
            "engines": [{
                "endpoint": i.get("endpoint", ""),
                "device_frac": float(i["device_frac"]),
                "accounting_frac": float(i.get("accounting_frac", 0.0)),
            } for i in rep],
        }

    def memory_section(self) -> dict:
        """The trainer-side /statusz ``memory`` block (and the
        FlightRecorder's ``memory_fn`` view): fleet worst-case KV
        residency + HBM headroom plus the per-engine rows, served from
        the cached sweep. Empty when no engine reports the ledger fields
        (ledger off fleet-wide, or engines predating it)."""
        with self._lock:
            insts = list(dict(self._last_status).get("instances", []))
        rep = [i for i in insts
               if i.get("healthy") and "kv_cold_page_frac" in i]
        if not rep:
            return {}
        fleet: dict = {
            "engines_reporting": len(rep),
            "kv_cold_page_frac_max": max(
                float(i["kv_cold_page_frac"]) for i in rep),
        }
        heads = [float(i["hbm_headroom_gb"]) for i in rep
                 if "hbm_headroom_gb" in i]
        if heads:
            fleet["hbm_headroom_gb_min"] = min(heads)
        spilled = [float(i["kv_spilled_frac"]) for i in rep
                   if "kv_spilled_frac" in i]
        if spilled:
            fleet["kv_spilled_frac_max"] = max(spilled)
        restores = [float(i["kv_restore_rate"]) for i in rep
                    if "kv_restore_rate" in i]
        if restores:
            fleet["kv_restore_rate_max"] = max(restores)
        return {
            "fleet": fleet,
            "engines": [{
                "endpoint": i.get("endpoint", ""),
                "kv_cold_page_frac": float(i["kv_cold_page_frac"]),
                **({"hbm_headroom_gb": float(i["hbm_headroom_gb"])}
                   if "hbm_headroom_gb" in i else {}),
                **({"kv_spilled_frac": float(i["kv_spilled_frac"])}
                   if "kv_spilled_frac" in i else {}),
                **({"kv_restore_rate": float(i["kv_restore_rate"])}
                   if "kv_restore_rate" in i else {}),
            } for i in rep],
        }

    def statusz_section(self) -> dict:
        """The /statusz ``pool`` block: membership + per-engine health,
        queue depth, weight version, and — with the transfer fabric
        attached — each engine's weight-sync health (pushed version, push
        failures, verify rejections, resume bytes, laggard flag), all
        served from the cached sweep so the exporter never blocks on a
        respawning manager."""
        with self._lock:
            st = dict(self._last_status)
            age = time.monotonic() - self._last_sweep if self._last_sweep \
                else -1.0
        sync: dict = {}
        if self.transfer_health_fn is not None:
            try:
                sync = dict(self.transfer_health_fn() or {})
            except Exception:  # noqa: BLE001 — health is best-effort
                log.warning("transfer sync-health probe failed",
                            exc_info=True)
        return {
            "counts": {k.split("/", 1)[1]: v
                       for k, v in self.counters(refresh=False).items()},
            "engines": [{
                "transfer": sync.get(i.get("endpoint", ""), {}),
                "endpoint": i.get("endpoint", ""),
                "is_local": bool(i.get("is_local")),
                "healthy": bool(i.get("healthy")),
                "active": bool(i.get("active")),
                "draining": bool(i.get("draining")),
                "weight_version": int(i.get("weight_version", -1)),
                "running": int(i.get("num_running_reqs", 0)),
                "queued": int(i.get("num_queued_reqs", 0)),
                "heartbeat_misses": int(i.get("heartbeat_misses", 0)),
                # flight-deck load view (0.0 for engines predating it)
                "occupancy": float(i.get("occupancy", 0.0)),
                "page_util": float(i.get("page_util", 0.0)),
                # sharded-push receive plane (receiver health): how many
                # parallel push streams this engine accepts per round and
                # its advertised tp shard count (1 = unsharded install)
                "push_streams": int(i.get("transfer_push_streams", 0)),
                "shard_tp": int(i.get("transfer_shard_tp", 1)),
            } for i in st.get("instances", [])],
            "snapshot_age_s": round(age, 3),
        }


class BalanceEstimator:
    """Progressive train↔rollout balance estimator.

    The manager's hill-climbing balancer (balance.h) actuates the
    colocated generation window from three scalars per step. Before this
    estimator those scalars were the LAST step's raw values, so one
    anomalous step (preemption drill, checkpoint write, a salvage resume
    wait) would swing the window by gap/3 off a measurement that says
    nothing about steady state. This maintains a sliding window of recent
    steps' goodput phase walls and feeds the balancer per-field MEDIANS —
    a robust baseline — plus
    ``pool/balance_*`` gauges so the step record shows what the balancer
    actually saw."""

    def __init__(self, window: int = 8):
        self.window = max(1, int(window))
        self._steps: deque[dict[str, float]] = deque(maxlen=self.window)
        self._lock = threading.Lock()

    def observe(self, *, step_time_s: float = 0.0,
                trainer_bubble_s: float = 0.0, throughput: float = 0.0,
                generate_s: float = 0.0, update_s: float = 0.0,
                occupancy: float = 0.0, device_frac: float = 0.0,
                **_ignored) -> None:
        """Fold one finished step in. ``generate_s``/``update_s`` are the
        goodput ledger's phase walls (timing_s/gen and the actor+critic
        update phases); ``occupancy`` the fleet-mean ``engine/occupancy``
        gauge (one step of lag — the sweep that produced it preceded this
        record); ``device_frac`` the fleet-MIN engine-loop profiler
        device fraction (same lag) — a fleet that looks busy by
        occupancy but is burning its wall host-side instead of on the
        device should not read as "add engines". Extra keys are accepted
        and ignored so callers can pass a whole stats dict through."""
        with self._lock:
            self._steps.append({
                "step_time_s": float(step_time_s),
                "trainer_bubble_s": float(trainer_bubble_s),
                "throughput": float(throughput),
                "generate_s": float(generate_s),
                "update_s": float(update_s),
                "occupancy": float(occupancy),
                "device_frac": float(device_frac),
            })

    def _window_median(self, key: str) -> float:
        return median(s[key] for s in self._steps) if self._steps else 0.0

    def trends(self) -> dict[str, float]:
        """Per-step least-squares slopes over the window — the
        balance-driven autoscaling input (ROADMAP: act on PoolManager
        add/drain). A rising occupancy slope with a rising bubble slope
        reads "the fleet is saturating and the trainer is starting to
        starve: add an engine"; both falling reads "drain one". Keys:
        ``{occupancy,bubble,step_time,throughput}_slope`` +
        ``window_steps`` + ``balance_trends_valid``; {} before the first
        observe.

        Cold-window guard: a least-squares slope over 1-2 points is
        noise (two points ALWAYS fit a line exactly), so with fewer than
        3 observed steps every slope is forced to 0.0 and
        ``balance_trends_valid`` is 0.0 — the AutoscaleController
        suppresses trend-driven actions until the window is real."""
        with self._lock:
            if not self._steps:
                return {}
            steps = list(self._steps)
        xs = list(range(len(steps)))
        valid = len(steps) >= 3

        def slope(key: str) -> float:
            if not valid:
                return 0.0
            return least_squares_slope(xs, [s[key] for s in steps])

        return {
            "occupancy_slope": slope("occupancy"),
            "bubble_slope": slope("trainer_bubble_s"),
            "step_time_slope": slope("step_time_s"),
            "throughput_slope": slope("throughput"),
            # engine-loop profiler feed: a falling fleet device_frac with
            # a rising occupancy reads "the engines are host-bound, not
            # device-bound — more engines won't help"
            "device_frac_slope": slope("device_frac"),
            "window_steps": float(len(steps)),
            "balance_trends_valid": 1.0 if valid else 0.0,
        }

    def stats(self) -> dict[str, float]:
        """Smoothed balancer feed (the update_metrics payload). Falls back
        to zeros before the first observe — the manager then keeps its
        initial window."""
        with self._lock:
            if not self._steps:
                return {}
            return {
                "step_time_s": self._window_median("step_time_s"),
                "trainer_bubble_s": self._window_median("trainer_bubble_s"),
                "throughput": self._window_median("throughput"),
            }

    def metrics(self) -> dict[str, float]:
        """``pool/balance_*`` step-record gauges: what the balancer saw,
        plus the estimated offload fraction — the share of generation the
        trainer-side update window can NOT hide, i.e. what should run on
        remote engines rather than the colocated one."""
        with self._lock:
            if not self._steps:
                return {}
            gen = self._window_median("generate_s")
            upd = self._window_median("update_s")
            bubble = self._window_median("trainer_bubble_s")
            step = self._window_median("step_time_s")
            device = self._window_median("device_frac")
        gen_total = gen + bubble  # colocated gen + blocked-on-remote time
        offload = gen_total / (gen_total + upd) if gen_total + upd > 0 else 0.0
        trends = self.trends()
        return {
            "pool/balance_window_steps": float(len(self._steps)),
            "pool/balance_step_time_s": step,
            "pool/balance_bubble_s": bubble,
            "pool/balance_generate_s": gen,
            "pool/balance_update_s": upd,
            "pool/balance_offload_frac": offload,
            # trend gauges (the autoscaling inputs): windowed per-step
            # slopes of fleet occupancy and the trainer bubble
            "pool/balance_occupancy_slope": trends.get(
                "occupancy_slope", 0.0),
            "pool/balance_bubble_slope": trends.get("bubble_slope", 0.0),
            # windowed fleet-min engine-loop device fraction (what the
            # balancer saw, not one sweep's snapshot)
            "pool/balance_device_frac": device,
            "pool/balance_trends_valid": trends.get(
                "balance_trends_valid", 0.0),
        }
