"""Fault-injection harness for the rollout plane (a copy of
``polyrl_tpu/rollout/faults.py``; token-level continuous
generation's test surface: SURVEY.md §5.3 "no fault-injection harness
exists; the build should add one").

One :class:`FaultInjector` instance can be attached at two seams:

- **engine/server side** (``RolloutServer.fault``): observes every
  admission and every outgoing stream line. Configurable kill-after-N-tokens
  (trips the request's abort event — with ``salvage_partials`` the engine
  flushes a partial and the manager's continuation resumes it elsewhere),
  chunk corruption (emits one unparseable line — the manager's decode-error
  eviction path), stream stall, and a /drain trigger after N admissions
  (graceful-preemption rehearsal).
- **trainer/client side** (``RemoteRollout(fault_injector=...)``): wraps the
  manager batch stream and raises a ``ManagerTransportError`` once every
  still-pending rid has salvaged at least ``stream_kill_min_progress``
  tokens — killing the stream at the worst possible moment so the salvage
  ledger's suffix re-issue is exercised for EVERY request.

The weight-push fabric has its own sibling pair —
:class:`TransferFaultConfig` / :class:`TransferFaultInjector` (config
``transfer.fault_injection.*``) — injecting frame corruption on the wire,
stream stalls past the bandwidth-keyed push deadline, and control-channel
kills mid-round, so the verified/resumable push path is drillable end to end.

Faults are keyed by the request's *base* rid (the manager appends ``#a<n>``
per attempt), so ``once_per_request`` means once per logical request across
every retry/continuation/suffix-resume, which keeps fault runs terminating.

Driven from config (``rollout.fault_injection.*`` and
``transfer.fault_injection.*``) and from tests.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FaultInjectionConfig:
    enabled: bool = False
    # -- engine/server-side triggers (RolloutServer.fault) -----------------
    kill_after_tokens: int = 0     # abort a request after N streamed tokens
    kill_limit: int = -1           # total kill budget (-1 = unlimited)
    once_per_request: bool = True  # at most one kill per logical rid
    corrupt_after_tokens: int = 0  # replace the Nth line with garbage
    corrupt_limit: int = 1         # total corrupted lines budget
    stall_s: float = 0.0           # stall each stream once, this long,
    stall_after_tokens: int = 1    #   after N tokens
    stall_after_requests: int = 0  # arm stalls only after N admissions
    #   (lets a run establish a healthy baseline first — the flight
    #   recorder's anomaly drill stalls step K, not step 1)
    stall_limit: int = -1          # total stall budget (-1 = unlimited)
    drain_after_requests: int = 0  # POST /drain semantics after N admissions
    # -- trainer/client-side trigger (RemoteRollout.fault_injector) --------
    stream_kill_times: int = 0       # how many manager streams to kill
    stream_kill_min_progress: int = 1  # fire only once EVERY pending rid
    #                                    has salvaged >= this many tokens
    # -- pool-drill trigger: kill a whole ENGINE mid-batch ------------------
    # Fires the registered ``engine_killer`` callback (tests/bench attach
    # e.g. ``server.kill`` — death WITHOUT notice) once the stream has
    # forwarded >= engine_kill_min_progress progress tokens, i.e. while
    # requests are provably mid-decode on the pool. Recovery is the pool's
    # job: heartbeat eviction + manager continuation on survivors.
    engine_kill_times: int = 0
    engine_kill_min_progress: int = 1


def base_rid(rid: str) -> str:
    """Strip the manager's per-attempt ``#a<n>`` suffix: fault bookkeeping
    must follow the logical request across retries and continuations."""
    return rid.rsplit("#a", 1)[0]


# --------------------------------------------------------------------------
# Transfer-plane faults (the weight-push fabric's chaos surface)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TransferFaultConfig:
    """Transfer-plane faults (config ``transfer.fault_injection.*``).

    All triggers are budgeted and optionally targeted at one instance by
    endpoint substring (empty = any), and each can be gated behind N clean
    push attempts to the matching instance (``*_after_attempts``) so a
    run's bootstrap catch-up push lands clean before the chaos arms —
    attempts are counted by ``SenderAgent`` via :meth:`note_attempt`."""
    enabled: bool = False
    # flip one payload byte of this many wire frames (the CRC32 trailer is
    # computed over the TRUE bytes, so the receiver detects and rejects)
    corrupt_frames: int = 0
    corrupt_instance: str = ""
    corrupt_after_attempts: int = 0
    # stall a stream before its first frame — a stall longer than the
    # bandwidth-keyed push deadline fails the attempt by timeout
    stall_s: float = 0.0
    stall_streams: int = -1        # total stall budget (-1 = unlimited)
    stall_instance: str = ""
    stall_after_attempts: int = 0
    # close the sender->receiver control channel right before the verify
    # handshake (mid-round control-plane death: the receiver must
    # reconnect and the retry re-push the round)
    kill_control_rounds: int = 0
    kill_control_instance: str = ""
    kill_control_after_attempts: int = 0


class TransferFaultInjector:
    """Sibling of :class:`FaultInjector` for the weight-push fabric;
    counters are cumulative and public (tests report them). Stalls sleep interruptibly —
    ``SenderAgent.stop()`` calls :meth:`stop` so a teardown mid-drill
    never waits out a sleeping fault."""

    def __init__(self, cfg: TransferFaultConfig | None = None, **overrides):
        if cfg is None:
            cfg = TransferFaultConfig(enabled=True, **overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._attempts: dict[str, int] = {}  # instance -> push attempts
        # telemetry
        self.corruptions = 0
        self.stalls = 0
        self.control_kills = 0

    def stop(self) -> None:
        self._stop.set()

    def counters(self) -> dict[str, float]:
        return {
            "fault/transfer_corruptions": float(self.corruptions),
            "fault/transfer_stalls": float(self.stalls),
            "fault/transfer_control_kills": float(self.control_kills),
        }

    def note_attempt(self, instance: str) -> None:
        """Called by the sender at the start of every push attempt — the
        ``*_after_attempts`` gates count these."""
        with self._lock:
            self._attempts[instance] = self._attempts.get(instance, 0) + 1

    def _armed(self, instance: str, target: str, after: int) -> bool:
        if not self.cfg.enabled:
            return False
        if target and target not in instance:
            return False
        return self._attempts.get(instance, 0) > after

    def take_corruption(self, instance: str, stream_idx: int) -> bool:
        """One corrupt frame off the budget (called per frame send)."""
        with self._lock:
            fire = (self.cfg.corrupt_frames > 0
                    and self._armed(instance, self.cfg.corrupt_instance,
                                    self.cfg.corrupt_after_attempts)
                    and self.corruptions < self.cfg.corrupt_frames)
            if fire:
                self.corruptions += 1
        if fire:
            log.warning("transfer fault: corrupting a frame on stream %d "
                        "-> %s", stream_idx, instance)
        return fire

    def maybe_stall(self, instance: str, stream_idx: int) -> None:
        """Stall this stream before its first frame (interruptible)."""
        with self._lock:
            fire = (self.cfg.stall_s > 0
                    and self._armed(instance, self.cfg.stall_instance,
                                    self.cfg.stall_after_attempts)
                    and (self.cfg.stall_streams < 0
                         or self.stalls < self.cfg.stall_streams))
            if fire:
                self.stalls += 1
        if fire:
            log.warning("transfer fault: stalling stream %d -> %s for "
                        "%.1fs", stream_idx, instance, self.cfg.stall_s)
            self._stop.wait(self.cfg.stall_s)

    def take_control_kill(self, instance: str) -> bool:
        """One mid-round control-channel kill off the budget."""
        with self._lock:
            fire = (self.cfg.kill_control_rounds > 0
                    and self._armed(instance,
                                    self.cfg.kill_control_instance,
                                    self.cfg.kill_control_after_attempts)
                    and self.control_kills < self.cfg.kill_control_rounds)
            if fire:
                self.control_kills += 1
        if fire:
            log.warning("transfer fault: killing the control channel to "
                        "%s mid-round", instance)
        return fire


class FaultInjector:
    """Config-driven fault source; all counters are cumulative and public
    (tests report them)."""

    def __init__(self, cfg: FaultInjectionConfig | None = None, **overrides):
        if cfg is None:
            cfg = FaultInjectionConfig(enabled=True, **overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self._lock = threading.Lock()
        self._tokens: dict[str, int] = {}   # base rid -> streamed tokens
        self._killed: set[str] = set()
        self._stalled: set[str] = set()
        self._admitted = 0
        self._drained = False
        # pool drill: a zero-arg callable that kills one engine (e.g.
        # ``RolloutServer.kill`` or ``FakeEngine.kill``); armed by
        # engine_kill_times in the config
        self.engine_killer = None
        # spot-market hook (rollout/spotmarket.py): when a SpotMarket is
        # attached its fault/spot_* counters ride the same step record as
        # the fault/* recovery counters its events cause
        self.spot = None
        # telemetry
        self.kills = 0
        self.corruptions = 0
        self.stalls = 0
        self.drains = 0
        self.stream_kills = 0
        self.engine_kills = 0

    def counters(self) -> dict[str, float]:
        out = {
            "fault/injected_kills": float(self.kills),
            "fault/injected_corruptions": float(self.corruptions),
            "fault/injected_stalls": float(self.stalls),
            "fault/injected_drains": float(self.drains),
            "fault/injected_stream_kills": float(self.stream_kills),
            "fault/injected_engine_kills": float(self.engine_kills),
        }
        if self.spot is not None:
            out.update(self.spot.counters())
        return out

    # -- engine/server-side hooks -------------------------------------------

    def on_submit(self, server, rid: str, abort_event) -> None:
        """Called by ``RolloutServer.submit`` for every admission."""
        if not self.cfg.enabled:
            return
        trigger_drain = False
        with self._lock:
            self._admitted += 1
            if (self.cfg.drain_after_requests > 0 and not self._drained
                    and self._admitted >= self.cfg.drain_after_requests):
                self._drained = True
                trigger_drain = True
        if trigger_drain:
            self.drains += 1
            log.warning("fault injection: draining server after %d "
                        "admissions", self._admitted)
            server.drain()

    def on_line(self, rid: str, line: dict, abort_event) -> str | None:
        """Called by the server for every outgoing NDJSON line; returns a
        replacement raw string (corruption) or None to serialize normally.
        May set the abort event (kill) or sleep (stall) as a side effect."""
        if not self.cfg.enabled:
            return None
        key = base_rid(rid)
        n_tok = len(line.get("token_ids", ()))
        with self._lock:
            count = self._tokens.get(key, 0) + n_tok
            self._tokens[key] = count
            do_stall = (self.cfg.stall_s > 0 and key not in self._stalled
                        and count >= self.cfg.stall_after_tokens
                        and self._admitted >= self.cfg.stall_after_requests
                        and (self.cfg.stall_limit < 0
                             or self.stalls < self.cfg.stall_limit))
            if do_stall:
                self._stalled.add(key)
                self.stalls += 1
            do_corrupt = (self.cfg.corrupt_after_tokens > 0
                          and count >= self.cfg.corrupt_after_tokens
                          and self.corruptions < self.cfg.corrupt_limit)
            if do_corrupt:
                self.corruptions += 1
            do_kill = (self.cfg.kill_after_tokens > 0
                       and count >= self.cfg.kill_after_tokens
                       and abort_event is not None
                       and not (self.cfg.once_per_request
                                and key in self._killed)
                       and (self.cfg.kill_limit < 0
                            or self.kills < self.cfg.kill_limit))
            if do_kill:
                self._killed.add(key)
                self.kills += 1
        if do_stall:
            time.sleep(self.cfg.stall_s)
        if do_kill:
            log.warning("fault injection: killing %s after %d tokens",
                        rid, count)
            abort_event.set()
        if do_corrupt:
            # unparseable JSON: exercises the manager's decode-error
            # eviction path (stream_from_instance parse failure)
            return '{"token_ids": [!corrupted-by-fault-injection\n'
        return None

    # -- trainer/client-side hook -------------------------------------------

    def wrap_stream(self, stream, pending_rids: list[str]):
        """Wrap ``ManagerClient.batch_generate_stream``: pass items through,
        then raise a transport error once every still-pending rid has
        reported >= ``stream_kill_min_progress`` salvageable tokens — the
        worst-case manager death for the salvage ledger to recover from.

        With ``engine_kill_times`` armed, also fires the registered
        ``engine_killer`` once the stream has forwarded
        ``engine_kill_min_progress`` progress tokens: the engine dies
        provably mid-batch (SIGKILL semantics — no drain, no notice) and
        the pool must recover by heartbeat eviction + continuation."""
        arm_stream = self.cfg.enabled and self.cfg.stream_kill_times > 0
        arm_engine = (self.cfg.enabled and self.cfg.engine_kill_times > 0
                      and self.engine_killer is not None)
        if not arm_stream and not arm_engine:
            yield from stream
            return
        from polyrl_tpu_torch.manager.client import (GenerateProgress,
                                               ManagerTransportError)

        progress = {r: 0 for r in pending_rids}
        total_progress = 0
        pending = set(pending_rids)
        for item in stream:
            if isinstance(item, GenerateProgress):
                if item.rid in progress:
                    progress[item.rid] += len(item.token_ids)
                    total_progress += len(item.token_ids)
            else:
                pending.discard(getattr(item, "rid", None))
            yield item
            kill_engine = False
            with self._lock:
                if (arm_engine
                        and self.engine_kills < self.cfg.engine_kill_times
                        and total_progress
                        >= self.cfg.engine_kill_min_progress):
                    self.engine_kills += 1
                    kill_engine = True
                armed = (arm_stream
                         and self.stream_kills < self.cfg.stream_kill_times)
                fire = (armed and pending
                        and all(progress[r] >= self.cfg.stream_kill_min_progress
                                for r in pending))
                if fire:
                    self.stream_kills += 1
            if kill_engine:
                log.warning("fault injection: killing an engine mid-batch "
                            "(%d rids pending)", len(pending))
                self.engine_killer()
            if fire:
                log.warning("fault injection: killing manager stream with "
                            "%d rids pending", len(pending))
                raise ManagerTransportError(
                    "fault injection: stream kill")
