"""Weight-transfer sender/receiver agents (a copy of
``polyrl_tpu/transfer/agents.py``: the same control protocol and wire).

Redesign of the reference's fabric (sender:
rlboost/weight_transfer/sender_agent.py:163-693, receiver:
receiver_agent.py:55-308). The reference bootstraps over RPyC and signals
status over ZMQ; here both collapse into ONE newline-delimited-JSON TCP
control channel (SURVEY §5.8 recommends collapsing the protocol diversity).

Flow (mirrors §3.3 of the survey):
- Receiver (inside each rollout server) allocates its buffer from the model
  layout, starts N TCP listener streams, connects to its assigned sender's
  control port and registers {instance, buffer_len, stream host/ports}.
- Sender holds the packed flat weight buffer. Its event loop bumps the
  version on trainer signal AND polls the manager every ``poll_s`` seconds
  (pull model — enables late joiners, sender_agent.py:324-340):
  /get_receive_instances -> stale instances -> parallel TCP fan-out ->
  per-instance verify handshake on the control channel -> async
  POST /update_weights so each instance rejoins the pool ASAP
  (sender_agent.py:617-624).

Every push is **verified, resumable, and supervised**: after the wire, the sender ships the
round's frame manifest (per-range CRC32 digests) on the control channel;
the receiver checks coverage + digests against its landed buffer and only
a verified round installs the version. A ``verify_failed`` answer carries
the failed ranges, and the retry re-pushes ONLY those (the receiver's
coverage ledger survives into the resume round). Each attempt runs under a
bandwidth-keyed deadline (``bytes / min_bandwidth_mbps + slack`` instead
of the old flat 600 s / 3600 s), retries ride a jittered exponential
backoff up to ``retry_budget``, and budget exhaustion escalates the
instance to the laggard callback (``PoolManager.escalate_laggard`` drains
+ deregisters it — dead capacity stops being re-pushed every poll).
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import random
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.rollout.faults import TransferFaultConfig

from .layout import ParamLayout, ShardSpec, alloc_buffer, build_resharding_map
from .tcp_engine import ReceiverSockets, TcpTransferEngine

log = logging.getLogger(__name__)


@dataclass
class TransferConfig:
    """``transfer.*`` config: supervision knobs for the weight-push fabric
    (README "Weight-fabric fault tolerance" knob blurb). The previously
    hardcoded flat timeouts (600 s serial / 3600 s streamed) survive only
    as CAPS — the operative per-attempt deadline is bandwidth-keyed."""
    # minimum acceptable effective push bandwidth, MB/s: an attempt's
    # deadline is bytes / (min_bandwidth_mbps * 1e6) + slack, capped below
    min_bandwidth_mbps: float = 50.0
    # deadline slack: fixed per-attempt overhead allowance (connection
    # setup, receiver arming, verify hand-off). Streamed rounds gate the
    # wire behind the in-place pack, so they get the larger slack.
    deadline_slack_s: float = 30.0
    stream_slack_s: float = 120.0
    # hard caps on any single attempt (the old flat timeouts)
    push_timeout_s: float = 600.0
    stream_push_timeout_s: float = 3600.0
    # prepare -> ready control handshake budget
    prepare_timeout_s: float = 60.0
    # integrity: CRC32 frame trailers are always on the wire; verify=False
    # skips the manifest handshake and installs on bare completion (the
    # pre-verification trusting path, kept as an escape hatch)
    verify: bool = True
    # per-push-call retry budget (attempts = retry_budget + 1) and the
    # jittered exponential backoff between attempts
    retry_budget: int = 2
    backoff_base_s: float = 0.5
    backoff_max_s: float = 10.0
    # transfer-plane chaos (rollout/faults.py TransferFaultInjector)
    fault_injection: TransferFaultConfig = field(
        default_factory=TransferFaultConfig)

    def push_deadline_s(self, nbytes: int, streamed: bool) -> float:
        cap = self.stream_push_timeout_s if streamed else self.push_timeout_s
        slack = self.stream_slack_s if streamed else self.deadline_slack_s
        bw = max(self.min_bandwidth_mbps, 1e-6) * 1e6
        return min(cap, nbytes / bw + slack)

    def stream_deadline_s(self, nbytes: int, streamed: bool) -> float:
        """Per-STREAM deadline of the sharded push: keyed to the bytes that
        one stream carries, so a stalled stream is detected after its own
        share's wire time — not after the whole round's — while the other
        streams keep landing."""
        return self.push_deadline_s(nbytes, streamed)


def _send_json(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


def _merge_ranges(rs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted union of (offset, length) ranges, merging overlaps/adjacency
    — a resume list must be disjoint (overlapping clears are idempotent on
    the receiver but would double-send bytes on the wire)."""
    rs = sorted((int(o), int(ln)) for o, ln in rs if int(ln) > 0)
    out: list[tuple[int, int]] = []
    for o, ln in rs:
        if out and o <= out[-1][0] + out[-1][1]:
            end = max(out[-1][0] + out[-1][1], o + ln)
            out[-1] = (out[-1][0], end - out[-1][0])
        else:
            out.append((o, ln))
    return out


class _LineReader:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def read(self, timeout: float | None = None) -> dict | None:
        self._sock.settimeout(timeout)
        while b"\n" not in self._buf:
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return None
            if not chunk:
                raise ConnectionError("control channel closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)


# --------------------------------------------------------------------------
# Receiver
# --------------------------------------------------------------------------


class ReceiverAgent:
    """Runs inside a rollout server; lands weight bytes into a host buffer.

    Unlike the reference (mp.Process per TP-rank-0, receiver_agent.py:295),
    this runs as a thread: ``recv_into`` releases the GIL, and the server
    is a single process per host — the landed entries are copied to the
    engine's device by the server's installer (the reference's chunked
    host->GPU broadcast, patches.py:169-241). ``pin_buffer`` page-locks the
    receive buffer (a server on the card), so those copies run as DMA.
    """

    def __init__(self, layout: ParamLayout, instance_endpoint: str,
                 sender_endpoint: str, num_streams: int = 4,
                 listen_host: str = "0.0.0.0", advertise_host: str | None = None,
                 reconnect_backoff_s: float = 0.2,
                 reconnect_backoff_max_s: float = 10.0,
                 shard_spec=None, pin_buffer: bool = False):
        self.layout = layout
        self.buffer = alloc_buffer(layout, pin=pin_buffer)
        # the engine's shard spec (transfer/layout.py ShardSpec), advertised
        # in the register message so the sender can build the trainer→engine
        # ReshardingMap for this receiver and fan the round over shard-owned
        # streams; None = replicated engine (tp=1)
        self.shard_spec = shard_spec
        self.instance_endpoint = instance_endpoint
        self.sender_host, self.sender_port = _split(sender_endpoint)
        self.sockets = ReceiverSockets(self.buffer, num_streams, listen_host)
        self.advertise_host = advertise_host or "127.0.0.1"
        self.version = -1
        self.error: str | None = None
        # sync-health telemetry (server_info "transfer_*" flat keys via
        # health(): a flapping control channel, rejected rounds, and the
        # resume traffic are all visible per engine)
        self.control_reconnects = 0
        self.verify_failures = 0   # rounds answered verify_failed
        self.rounds_verified = 0
        self.resumed_bytes = 0     # bytes landed via partial re-pushes
        self._reconnect_backoff_s = reconnect_backoff_s
        self._reconnect_backoff_max_s = reconnect_backoff_max_s
        self._armed_version = -1  # version of the round currently landing
        # held around every on_tensor emission batch (and the completion
        # tail): the prepare handler takes it before arming the NEXT round,
        # so a new push can never overwrite buffer bytes an installer is
        # still reading (torn-tensor guard for back-to-back syncs)
        self._install_lock = threading.Lock()
        self._version_cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        backoff = self._reconnect_backoff_s
        while not self._stop.is_set():
            try:
                with socket.create_connection(
                        (self.sender_host, self.sender_port), timeout=30.0) as s:
                    backoff = self._reconnect_backoff_s
                    _send_json(s, {
                        "cmd": "register",
                        "instance": self.instance_endpoint,
                        "buffer_len": int(self.buffer.nbytes),
                        "host": self.advertise_host,
                        "ports": self.sockets.ports,
                        "shard_spec": (self.shard_spec.to_jsonable()
                                       if self.shard_spec is not None
                                       else None),
                    })
                    reader = _LineReader(s)
                    while not self._stop.is_set():
                        msg = reader.read(timeout=1.0)
                        if msg is None:
                            continue
                        if msg.get("event") == "prepare":
                            # serialize behind a mid-flight incremental
                            # install: its buffer reads must finish before
                            # this round's bytes land over them (sender
                            # retries if "ready" is delayed past its gate)
                            resume = msg.get("resume") or None
                            with self._install_lock:
                                with self._version_cv:
                                    self._armed_version = int(
                                        msg.get("version", -1))
                                self.sockets.arm(
                                    int(msg["round"]),
                                    reset=resume is None,
                                    clear=[(int(o), int(ln))
                                           for o, ln in resume]
                                    if resume else None)
                            _send_json(s, {"event": "ready",
                                           "instance": self.instance_endpoint})
                        elif msg.get("event") == "verify":
                            # verified install: coverage + manifest digests
                            # must check out against the landed buffer
                            # BEFORE the version installs; a failure
                            # answers the ranges the sender must re-push
                            ok, missing, detail = self._verify_round(msg)
                            _send_json(s, {
                                "event": "verify_result",
                                "instance": self.instance_endpoint,
                                "round": int(msg.get("round", -1)),
                                "version": int(msg.get("version", -1)),
                                "ok": ok,
                                "missing": [[o, ln] for o, ln in missing],
                                "error": detail,
                            })
                        elif msg.get("event") == "transfer_done":
                            # trusting path (transfer.verify=false) and the
                            # sender's best-effort failure notification
                            if msg.get("status") != "success":
                                log.error("transfer failed: %s", msg)
                                continue
                            self.sockets.wait(timeout=600.0)
                            with self._version_cv:
                                self.version = int(msg["version"])
                                self._version_cv.notify_all()
                        elif msg.get("event") == "error":
                            # permanent rejection (e.g. layout/buffer-size
                            # mismatch): surface loudly, stop retrying
                            self.error = str(msg.get("error", "unknown"))
                            log.error("sender rejected registration: %s",
                                      self.error)
                            return
            except (OSError, ConnectionError) as exc:
                if self._stop.is_set():
                    return
                # capped + jittered: a fleet of receivers losing one sender
                # must not reconnect in lockstep, and a dead sender must
                # not be hammered at 5 Hz forever
                self.control_reconnects += 1
                sleep = backoff * (0.5 + random.random())
                log.warning("receiver control reconnect #%d in %.2fs (%s)",
                            self.control_reconnects, sleep, exc)
                self._stop.wait(sleep)
                backoff = min(backoff * 2, self._reconnect_backoff_max_s)

    def _verify_round(self, msg: dict) -> tuple[bool, list, str]:
        """The receiver's side of the verify handshake: wait for the armed
        round's streams to terminate, then check the sender's manifest
        (range digests) AND full-buffer coverage against the ledger. Only
        a clean round installs the version — a corrupt or torn round is
        rejected *without* installing, and the answer carries exactly the
        ranges the sender must re-push."""
        rnd = int(msg.get("round", -1))
        version = int(msg.get("version", -1))
        manifest = [(int(o), int(ln), int(c))
                    for o, ln, c in msg.get("manifest") or []]
        wait_s = float(msg.get("wait_s", 30.0))
        if self.sockets._round != rnd:
            return False, [], (f"round {rnd} superseded by "
                               f"{self.sockets._round}")
        resume = self.sockets.resume_round
        # best-effort completion wait: a dead stream just leaves gaps,
        # which the ledger check below turns into resumable ranges
        self.sockets.wait_done(timeout=wait_s)
        missing = self.sockets.verify_ranges(manifest)
        if not missing:
            # belt and braces beyond the manifest: the union of verified
            # manifests must cover the whole buffer (gap detection)
            missing = self.sockets.gaps(int(self.buffer.nbytes))
        if missing:
            self.verify_failures += 1
            return False, missing, f"{len(missing)} ranges failed verify"
        if resume:
            self.resumed_bytes += sum(ln for _, ln, _ in manifest)
        self.rounds_verified += 1
        with self._version_cv:
            if version > self.version:
                self.version = version
            self._version_cv.notify_all()
        return True, [], ""

    def health(self) -> dict[str, int]:
        """Flat ``transfer_*`` sync-health keys for the rollout server's
        ``server_info`` (→ /statusz gauges): is this engine's receiver
        flapping, rejecting rounds, or riding resume traffic?"""
        return {
            "transfer_control_reconnects": int(self.control_reconnects),
            "transfer_crc_frame_failures": int(self.sockets.crc_failures),
            "transfer_verify_failures": int(self.verify_failures),
            "transfer_rounds_verified": int(self.rounds_verified),
            "transfer_resumed_bytes": int(self.resumed_bytes),
            "transfer_weight_version": int(self.version),
            "transfer_push_streams": len(self.sockets.ports),
            "transfer_shard_tp": int(self.shard_spec.num_shards
                                     if self.shard_spec else 1),
        }

    def wait_for_version(self, version: int, timeout: float = 600.0,
                         on_tensor=None) -> int:
        """Block until weights of at least ``version`` are in the buffer
        (the reference's 'receive_weights' wait, receiver_agent.py:257-268).
        Returns the version whose bytes were actually installed — ≥ the
        requested one when a superseding round landed instead (callers
        recording ``engine.weight_version`` must use the RETURN value, not
        the request, or they under-report until the next push).

        ``on_tensor(entry, np_view)``: incremental install hook — invoked
        IN LAYOUT ORDER for each tensor whose bytes have fully landed,
        while later tensors are still on the wire (overlaps the wire with
        the device upload; reference overlap: sender_agent.py:567-647).
        Landed bytes are final (streams send monotonically from a stable
        snapshot), so a completed tensor never changes within a round. If
        a retry/newer round supersedes the one being tailed, every tensor
        is re-emitted from the final buffer — the consumer must treat
        emissions as idempotent upserts by name.

        The install lock is dropped BETWEEN tensor emissions
        (``on_tensor`` is a device upload that can take seconds, and the
        sender's prepare→ready gate is 60 s — holding the lock across a
        whole emission batch starved back-to-back pushes into spurious
        manager aborts). A prepare arriving between two tensors arms the
        new round; the next iteration observes it under the lock and stops
        reading the old bytes before any stream can overwrite them."""
        deadline = time.monotonic() + timeout
        emitted = 0
        tail_round = None
        from .layout import covered_entries

        def emit_landed() -> None:
            nonlocal emitted, tail_round
            if on_tensor is None:
                return
            while True:
                with self._version_cv:
                    armed = self._armed_version
                if armed != target:  # only tail the round we wait on
                    return
                with self._install_lock:
                    rnd = self.sockets._round
                    if rnd != tail_round:
                        tail_round, emitted = rnd, 0  # retry: start over
                    es = covered_entries(self.layout,
                                         self.sockets.coverage(), emitted,
                                         limit=1)
                    if not es:
                        return
                    e = es[0]  # ONE tensor per lock hold (see docstring)
                    on_tensor(e, self.buffer[e.offset : e.offset + e.nbytes])
                    emitted += 1

        target = version
        while True:
            with self._version_cv:
                while self.version < target:
                    if self._stop.is_set():
                        raise ConnectionError("receiver stopped")
                    if self.error is not None:
                        raise ConnectionError(
                            f"receiver registration rejected: {self.error}")
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(
                            f"weights v{target} not received "
                            f"(have v{self.version})")
                    if on_tensor is not None:
                        self._version_cv.release()
                        try:
                            emit_landed()
                        finally:
                            self._version_cv.acquire()
                        self._version_cv.wait(min(left, 0.05))
                    else:
                        self._version_cv.wait(min(left, 1.0))
                final = self.version
            if on_tensor is None:
                return final
            # completion tail: emit the remaining entries, one lock hold
            # per tensor (the NEXT round's prepare waits out at most one
            # upload, not the whole tail). The round id AND armed
            # version are re-read under the lock on EVERY iteration, and
            # emission is gated on the current round's landed coverage: a
            # SAME-version re-push (sender retry) arming mid-tail changes
            # sockets._round and resets coverage, which restarts the tail
            # and blocks it until the new round's bytes land — without
            # this the tail would keep emitting buffer ranges the retry's
            # streams are actively overwriting.
            superseded = False
            if final != target:
                emitted, tail_round = 0, None  # stale pre-wait progress
            while not superseded:
                progressed = False
                with self._install_lock:
                    with self._version_cv:
                        armed = self._armed_version
                        cur = self.version
                    if armed > cur or cur != final:
                        # a SUPERSEDING round armed (streams will land over
                        # the buffer) — or armed AND completed within one
                        # inter-tensor lock gap (cur moved past the version
                        # this tail was emitting): either way the remaining
                        # bytes are not round-``final``'s — restart the
                        # tail against the newest version (still "at least
                        # version"). Without the ``cur != final`` arm a
                        # fully-landed supersede would mix two versions'
                        # tensors into one install.
                        target = max(armed, cur)
                        emitted, tail_round = 0, None
                        superseded = True
                        continue
                    rnd = self.sockets._round
                    if rnd != tail_round:
                        # re-push of the SAME version restarted the round:
                        # start over against its (reset) coverage
                        tail_round, emitted = rnd, 0
                    if emitted >= len(self.layout.entries):
                        return final
                    es = covered_entries(self.layout,
                                         self.sockets.coverage(), emitted,
                                         limit=1)
                    if es:
                        e = es[0]
                        on_tensor(e,
                                  self.buffer[e.offset : e.offset + e.nbytes])
                        emitted += 1
                        progressed = True
                if not progressed:
                    # mid re-push: the next entry's bytes have not landed
                    # yet — wait for stream progress instead of emitting
                    # bytes that are being overwritten
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"weights v{final} install tail stalled behind "
                            f"an incomplete re-push")
                    with self._version_cv:
                        self._version_cv.wait(0.05)

    def stop(self) -> None:
        self._stop.set()
        with self._version_cv:
            self._version_cv.notify_all()  # break waiting installers out
        self.sockets.close()
        if self._thread:
            self._thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# Sender
# --------------------------------------------------------------------------


@dataclass
class _Registration:
    instance: str
    host: str
    ports: list[int]
    sock: socket.socket
    lock: threading.Lock = field(default_factory=threading.Lock)
    ready: threading.Event = field(default_factory=threading.Event)
    # verify handshake response slot: _handle_conn parks the receiver's
    # verify_result here and sets the event; _push_one round-checks it
    verify_evt: threading.Event = field(default_factory=threading.Event)
    verify_msg: dict | None = None
    pushed_version: int = -1
    # the engine's advertised ShardSpec (None = replicated) and the cached
    # per-stream assignment plan built from it on first push — invalidated
    # only by re-registration, since layout and spec are both immutable for
    # a registration's lifetime
    shard_spec: object | None = None
    stream_plan: list | None = None
    reshard_total: int = 0


class SenderAgent:
    """Trainer-side transfer agent (thread; reference uses an mp.Process,
    sender_agent.py:682-694 — a thread suffices since pack/send release the
    GIL and lets the trainer overlap transfer with the next step)."""

    def __init__(self, buffer: np.ndarray, manager_client=None,
                 listen_host: str = "0.0.0.0", num_streams: int = 4,
                 poll_s: float = 1.0, advertise_host: str | None = None,
                 bind_host: str | None = None,
                 cfg: TransferConfig | None = None, fault=None,
                 layout: ParamLayout | None = None,
                 trainer_spec=None):
        self.buffer = buffer
        self.manager = manager_client
        self.cfg = cfg or TransferConfig()
        # sharded-push inputs: with a layout, each receiver's advertised
        # ShardSpec yields a ReshardingMap whose stream_assignments fan the
        # round over num_streams shard-owned range lists (layout=None keeps
        # the legacy contiguous split)
        self.layout = layout
        self.trainer_spec = trainer_spec
        # transfer-plane chaos injector (rollout/faults.py); interruptible
        # on stop() so a sleeping stall never pins teardown
        self.fault = fault
        # bind_host pins this sender's outbound data streams to one NIC
        # (SenderGroup runs one agent per interface for aggregate
        # bandwidth). Worker headroom beyond num_streams: multi-instance
        # fan-out shares this pool, and one instance's stalled stream must
        # not head-of-line-block another instance's sends into a spurious
        # deadline miss.
        self.engine = TcpTransferEngine(num_streams=num_streams,
                                        workers=max(num_streams * 4, 8),
                                        bind_host=bind_host)
        self._notify_pool = ThreadPoolExecutor(max_workers=4)
        # per-instance push fan-out: an executor (not bare threads) so
        # teardown mid-push can cancel queued pushes (cancel_futures) and
        # the conftest thread-leak guard sees pool workers, not strays
        self._push_pool = ThreadPoolExecutor(max_workers=16)
        self.poll_s = poll_s
        self.reg_wait_s = 10.0
        self.version = -1
        self._regs: dict[str, _Registration] = {}
        self._regs_lock = threading.Lock()
        # supervision ledgers (under _regs_lock): per-instance sync health
        # for /statusz, and the escalated-instances blocklist that stops a
        # laggard from being re-pushed at the same version every poll
        self._health: dict[str, dict] = {}
        self._escalated: dict[str, int] = {}  # instance -> version
        self._cmds: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # (buffer, version) pairing protocol: a push round snapshots both
        # under _cv with _inflight+=1; a swap/pack waits for _inflight==0.
        # Packing into a DIFFERENT (back) buffer overlaps with in-flight
        # rounds — only the pointer swap synchronizes (the reference gets
        # this overlap from its agent process, sender_agent.py:682-694).
        self._cv = threading.Condition()
        self._inflight = 0
        self._packing = False
        self._watermark = None  # streaming push: gates sends behind the pack
        self._poisoned_version = -1  # streamed pack died: never push this
        self._round_counter = 0  # unique per push attempt (stale-stream guard)
        # laggard escalation hook: called as cb(instance, reason) when an
        # instance exhausts its retry budget (train.py wires
        # PoolManager.escalate_laggard — drain + deregister)
        self.laggard_cb = None
        # supervision telemetry (cumulative; TransferInterface.counters()
        # folds these into transfer/* step-record gauges)
        self.push_failures = 0       # failed push attempts (any cause)
        self.push_retries = 0        # attempts re-run after a failure
        self.verify_failures = 0     # attempts rejected by receiver verify
        self.resumed_bytes = 0       # bytes re-pushed via partial resumes
        self.rounds_verified = 0     # verified installs
        self.laggard_escalations = 0
        # elastic-pool telemetry: full pushes to instances this sender had
        # never pushed before — the scale-up catch-up path (a late joiner
        # registers, the idle poll finds it stale, it gets the CURRENT
        # version in one round, then rides the normal push fan-out)
        self.catchup_pushes = 0
        # sharded-push telemetry: streams the last round fanned over, the
        # slowest stream's bandwidth that round (the round's critical path),
        # cumulative bytes carried on shard-pair-owned ranges, and how many
        # individual stream failures were converted into partial resumes
        # instead of full re-pushes
        self.push_streams = 0
        self.stream_bw_mbps_min = 0.0
        self.reshard_bytes = 0
        self.stream_resumes = 0
        # the last verified rounds, oldest first: {instance, version,
        # push_s (prepare to verified, the wire and the verify), bytes,
        # resumed}
        self.round_log: list[dict] = []
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((listen_host, 0))
        self._server.listen(64)
        self.control_port = self._server.getsockname()[1]
        self.endpoint = f"{advertise_host or _advertise_ip()}:{self.control_port}"
        self._threads: list[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for target in (self._accept_loop, self._event_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self.fault is not None:
            # wake any injected stall so teardown never waits it out
            self.fault.stop()
        try:
            # shutdown wakes the accept loop blocked on the listener (a
            # bare close does not on Linux), so the join below is prompt
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        # break registered control channels: blocked handshake waits and
        # the receivers' readers return immediately instead of timing out
        with self._regs_lock:
            regs = list(self._regs.values())
        for reg in regs:
            try:
                reg.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.engine.shutdown()
        self._push_pool.shutdown(wait=False, cancel_futures=True)
        self._notify_pool.shutdown(wait=False, cancel_futures=True)
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    # -- trainer API --------------------------------------------------------

    def signal_update(self, version: int | None = None) -> int:
        """Trainer signals new weights are packed (in-place into
        ``self.buffer``); returns the new version."""
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()
            self.version = version if version is not None else self.version + 1
            self._watermark = None
            v = self.version
        self._cmds.put("update_weights")
        return v

    def signal_update_streaming(self, watermark,
                                version: int | None = None) -> int:
        """Streaming push: announce the version BEFORE packing; sends are
        gated behind ``watermark`` while the caller packs in place into
        ``self.buffer`` (the watermark orders buffer access: senders read
        only below it, the packer writes only above it). The reference's
        in-round sender pipeline (sender_agent.py:567-647)."""
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()
            self.version = version if version is not None else self.version + 1
            self._watermark = watermark
            v = self.version
        self._cmds.put("update_weights")
        return v

    def mark_push_failed(self, version: int) -> None:
        """A streamed pack died mid-round: the buffer holds garbage for
        ``version``. Poison it so the poll loop stops re-pushing it every
        ``poll_s`` (each retry would fail at the watermark and spam the
        manager with aborts); the next successful signal/swap resumes."""
        with self._cv:
            self._poisoned_version = version
        log.error("weight push v%d poisoned (pack failed); waiting for a "
                  "new update", version)

    def swap_buffer(self, new_buffer: np.ndarray, version: int) -> np.ndarray:
        """Atomically install a freshly packed buffer; returns the old one
        (double-buffering: the caller packs the next update into it)."""
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()
            old, self.buffer = self.buffer, new_buffer
            self.version = version
            self._watermark = None
        self._cmds.put("update_weights")
        return old

    class _PackGuard:
        def __init__(self, sender: "SenderAgent"):
            self._s = sender

        def __enter__(self):
            with self._s._cv:
                while self._s._inflight > 0 or self._s._packing:
                    self._s._cv.wait()
                self._s._packing = True

        def __exit__(self, *exc):
            with self._s._cv:
                self._s._packing = False
                self._s._cv.notify_all()

    def buffer_write_lock(self) -> "_PackGuard":
        """Guard for packing in place into ``self.buffer`` (direct mode);
        blocks while a push round is in flight and vice versa."""
        return SenderAgent._PackGuard(self)

    # -- registration server ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        reader = _LineReader(conn)
        reg: _Registration | None = None
        try:
            while not self._stop.is_set():
                msg = reader.read(timeout=1.0)
                if msg is None:
                    continue
                if msg.get("cmd") == "register":
                    if int(msg["buffer_len"]) != int(self.buffer.nbytes):
                        _send_json(conn, {"event": "error",
                                          "error": "buffer size mismatch"})
                        return
                    reg = _Registration(instance=msg["instance"],
                                        host=msg["host"],
                                        ports=list(msg["ports"]), sock=conn,
                                        shard_spec=ShardSpec.from_jsonable(
                                            msg.get("shard_spec")))
                    with self._regs_lock:
                        self._regs[reg.instance] = reg
                        # a fresh registration clears any standing laggard
                        # escalation: a restarted/recovered receiver gets a
                        # fresh retry budget
                        self._escalated.pop(reg.instance, None)
                    _send_json(conn, {"event": "registered",
                                      "version": self.version})
                    log.info("receiver registered: %s", reg.instance)
                elif msg.get("event") == "ready" and reg is not None:
                    reg.ready.set()
                elif msg.get("event") == "verify_result" and reg is not None:
                    reg.verify_msg = msg
                    reg.verify_evt.set()
        except (ConnectionError, OSError):
            pass
        finally:
            if reg is not None:
                with self._regs_lock:
                    if self._regs.get(reg.instance) is reg:
                        del self._regs[reg.instance]

    # -- event loop (pull model) --------------------------------------------

    def _event_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._cmds.get(timeout=self.poll_s)
            except queue.Empty:
                pass  # idle poll — late joiners (sender_agent.py:324-340)
            if self._stop.is_set():
                return
            if self.version < 0:
                continue
            try:
                self._check_and_update_receivers()
            except Exception:  # noqa: BLE001 — keep the loop alive
                log.exception("weight push round failed")

    def _stale_instances(self, version: int) -> list[str]:
        if self.manager is None:
            with self._regs_lock:
                stale = [i for i, r in self._regs.items()
                         if r.pushed_version < version]
        else:
            resp = self.manager.get_receive_instances(self.endpoint)
            stale = [i["endpoint"] if isinstance(i, dict) else i
                     for i in resp.get("instances", [])]
        # escalated laggards are dead capacity at this version: the
        # laggard callback drains+deregisters them, but until that lands
        # (and forever in manager-less mode) the poll must not re-push
        # them every poll_s. A NEW version or a fresh registration clears
        # the blocklist entry.
        with self._regs_lock:
            esc = dict(self._escalated)
        return [i for i in stale if esc.get(i) != version]

    def _wait_registration(self, instance: str) -> _Registration | None:
        """Bootstrap race: the manager may hand us an instance whose receiver
        hasn't connected yet (the reference's wait_for_receiver_registration,
        sender_agent.py:342-351)."""
        deadline = time.monotonic() + self.reg_wait_s
        while time.monotonic() < deadline and not self._stop.is_set():
            with self._regs_lock:
                reg = self._regs.get(instance)
            if reg is not None:
                return reg
            time.sleep(0.05)
        return None

    def _check_and_update_receivers(self) -> None:
        # snapshot (buffer, version) atomically; the round holds an inflight
        # ref so swaps/packs wait, but packing the BACK buffer proceeds in
        # parallel with the sends.
        with self._cv:
            while self._packing:
                self._cv.wait()
            version = self.version
            buffer = self.buffer
            watermark = self._watermark
            if version == self._poisoned_version:
                return  # failed streamed pack: nothing valid to push
            self._inflight += 1
        try:
            stale = self._stale_instances(version)
            if not stale:
                return
            futures = [self._push_pool.submit(self._push_instance, i,
                                              version, buffer, watermark)
                       for i in stale]
            for f in futures:
                f.result()
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _abort_on_manager(self, instance: str) -> None:
        """Clear the manager's updating_weight CAS so the instance is
        retried next poll instead of being drained forever."""
        if self.manager is not None:
            try:
                self._notify_pool.submit(self.manager.abort_weight_update,
                                         [instance])
            except RuntimeError:
                # agent closing: notify pool already shut down; the manager
                # side times the CAS out on its own
                pass

    def _note_health(self, instance: str, inc: dict | None = None,
                     **set_kv) -> None:
        """Fold one event into the per-instance sync-health ledger (the
        ``transfer`` block of the /statusz pool section)."""
        with self._regs_lock:
            h = self._health.setdefault(instance, {
                "pushed_version": -1, "push_failures": 0,
                "verify_failures": 0, "resumed_bytes": 0,
                "stream_resumes": 0,
                "last_push_s": None, "escalated": False, "last_error": ""})
            for k, v in (inc or {}).items():
                h[k] = h.get(k, 0) + v
            h.update(set_kv)

    def sync_health(self) -> dict[str, dict]:
        """Per-instance push health: ``{endpoint: {pushed_version,
        push_failures, verify_failures, resumed_bytes, last_push_s,
        escalated, registered, last_error}}`` — PoolManager merges this
        into the /statusz pool section's engine rows."""
        with self._regs_lock:
            regs = set(self._regs)
            esc = set(self._escalated)
            out = {i: dict(h) for i, h in self._health.items()}
        for i in regs:
            out.setdefault(i, {})
        for i, h in out.items():
            h["registered"] = i in regs
            h["escalated"] = bool(h.get("escalated")) or i in esc
        return out

    def counters(self) -> dict[str, float]:
        """Cumulative ``transfer/*`` supervision gauges for step records."""
        return {
            "transfer/push_failures": float(self.push_failures),
            "transfer/push_retries": float(self.push_retries),
            "transfer/verify_failures": float(self.verify_failures),
            "transfer/resumed_bytes": float(self.resumed_bytes),
            "transfer/rounds_verified": float(self.rounds_verified),
            "transfer/laggard_escalations": float(self.laggard_escalations),
            "transfer/catchup_pushes": float(self.catchup_pushes),
            "transfer/push_streams": float(self.push_streams),
            "transfer/stream_bw_mbps_min": float(self.stream_bw_mbps_min),
            "transfer/reshard_bytes": float(self.reshard_bytes),
            "transfer/stream_resumes": float(self.stream_resumes),
        }

    def _escalate(self, instance: str, version: int, err: str) -> None:
        """Retry budget exhausted: the instance is a laggard — dead
        capacity the bootstrap gate already holds out of routing. Stop
        re-pushing it (same-version blocklist) and hand it to the fleet
        control plane (PoolManager.escalate_laggard drains + deregisters).
        Without a callback the manager CAS is cleared so a FUTURE version
        may retry — but the blocklist stops the every-``poll_s`` re-push
        of this one."""
        self.laggard_escalations += 1
        self._note_health(instance, escalated=True, last_error=err)
        log.error("weight push to %s exhausted its retry budget at v%d "
                  "(%s); escalating laggard", instance, version, err)
        with self._regs_lock:
            self._escalated[instance] = version
        cb = self.laggard_cb
        if cb is not None:
            try:
                # off the push thread: the callback drains + deregisters
                # over HTTP and must not block the round's fan-out join
                self._notify_pool.submit(cb, instance, err)
            except RuntimeError:
                pass  # agent closing
        else:
            self._abort_on_manager(instance)

    def _push_instance(self, instance: str, version: int,
                       buffer: np.ndarray, watermark=None) -> None:
        """Supervised push: attempts = 1 + retry_budget, each under the
        bandwidth-keyed deadline, separated by jittered exponential
        backoff. A ``verify_failed`` attempt resumes — the next attempt
        re-pushes ONLY the failed ranges; a transport failure re-pushes in
        full. Budget exhaustion escalates the laggard."""
        cfg = self.cfg
        missing: list[tuple[int, int]] | None = None
        registered_once = False
        last_err = ""
        attempt = 0
        while not self._stop.is_set():
            reg = self._wait_registration(instance)
            if reg is None:
                if not registered_once:
                    # bootstrap race, not a laggard: the manager handed us
                    # an instance whose receiver never connected. Clear
                    # the CAS so a later poll retries once it registers.
                    log.error("no receiver registration for %s; "
                              "skipping push", instance)
                    self._abort_on_manager(instance)
                    return
                last_err = "receiver registration lost"
                missing = None
            else:
                registered_once = True
                try:
                    missing, rejected = self._push_one(reg, version, buffer,
                                                       watermark,
                                                       ranges=missing)
                    if not missing:
                        return  # verified + installed
                    if rejected:
                        # the RECEIVER rejected landed bytes (digest/gap
                        # check) — distinct from a sender-side stream
                        # failure, which resumes without being a verify
                        # failure (the fabric didn't reject clean bytes)
                        self.verify_failures += 1
                        self._note_health(instance,
                                          inc={"verify_failures": 1})
                        last_err = f"verify_failed ({len(missing)} ranges)"
                    else:
                        last_err = f"stream_failed ({len(missing)} ranges)"
                    log.warning("push v%d to %s incomplete: %s",
                                version, instance, last_err)
                except Exception as exc:  # noqa: BLE001 — retried below
                    last_err = f"{type(exc).__name__}: {exc}"
                    missing = None  # transport failure: full re-push
                    self._notify_transfer_failed(reg, version, last_err)
                    log.error("push v%d to %s failed: %s", version,
                              instance, last_err)
            self.push_failures += 1
            self._note_health(instance, inc={"push_failures": 1},
                              last_error=last_err)
            if self._departed(instance):
                # it left the pool mid-round (a drained or evicted engine
                # is shut down): not a laggard, and retrying would hold
                # this round, and every later version's, for the whole
                # retry budget
                log.warning("push v%d to %s dropped: it left the pool (%s)",
                            version, instance, last_err)
                return
            attempt += 1
            if attempt > cfg.retry_budget:
                self._escalate(instance, version, last_err)
                return
            self.push_retries += 1
            sleep = min(cfg.backoff_base_s * (2 ** (attempt - 1)),
                        cfg.backoff_max_s) * (0.5 + random.random())
            if self._stop.wait(sleep):
                return

    def _departed(self, instance: str) -> bool:
        """Whether the manager no longer lists ``instance`` (False without
        a manager, or when the manager cannot be asked)."""
        if self.manager is None:
            return False
        try:
            insts = self.manager.get_instances_status().get("instances", [])
        except Exception:  # noqa: BLE001 — retry as before
            return False
        return all(i.get("endpoint") != instance for i in insts)

    @staticmethod
    def _notify_transfer_failed(reg: _Registration, version: int,
                                err: str) -> None:
        """Best-effort failure notice so the receiver's log shows cause."""
        try:
            _send_json(reg.sock, {"event": "transfer_done",
                                  "status": "failure", "version": version,
                                  "error": err})
        except OSError:
            pass

    def _stream_plan(self, reg: _Registration):
        """Lazily build (and cache on the registration) the sharded
        per-stream assignment plan for this receiver: the trainer→engine
        :class:`~polyrl_tpu_torch.transfer.layout.ReshardingMap` packed into
        min(num_streams, receiver ports) balanced range lists. None when
        the sender has no layout (legacy contiguous split)."""
        if self.layout is None or self.layout.total_bytes != self.buffer.nbytes:
            return None
        if reg.stream_plan is None:
            rmap = build_resharding_map(self.layout, self.trainer_spec,
                                        reg.shard_spec)
            n = min(self.engine.num_streams, len(reg.ports)) or 1
            reg.stream_plan = rmap.stream_assignments(n)
            reg.reshard_total = rmap.reshard_bytes()
        return reg.stream_plan

    def _collect_streams(self, batch, t0: float, streamed: bool):
        """Per-stream supervision of one wire round: each stream is waited
        under its OWN bandwidth-keyed deadline (anchored at ``t0`` — the
        streams run concurrently). Returns (manifest, missing_pre, errors):
        the concatenated frame manifests of the streams that landed, the
        full assigned ranges of those that didn't (re-pushed on resume —
        a dead stream's partially-landed tail is not trusted), and one
        error string per failed stream."""
        cfg = self.cfg
        manifest: list[tuple[int, int, int]] = []
        missing_pre: list[tuple[int, int]] = []
        errors: list[str] = []
        bw_min = None
        for i, fut in enumerate(batch.futures):
            assigned = (batch.assignments[i]
                        if i < len(batch.assignments) else [])
            sbytes = sum(ln for _, ln in assigned)
            dl = cfg.stream_deadline_s(sbytes, streamed)
            remaining = (t0 + dl) - time.monotonic()
            try:
                manifest.extend(fut.result(timeout=max(0.05, remaining))
                                or [])
                dt = time.monotonic() - t0
                if sbytes and dt > 0:
                    bw = sbytes / dt / 1e6
                    bw_min = bw if bw_min is None else min(bw_min, bw)
            except Exception as exc:  # noqa: BLE001 — per-stream resume
                errors.append(f"stream {i}: {type(exc).__name__}: {exc}")
                missing_pre.extend(assigned)
        self.push_streams = len(batch.futures)
        if bw_min is not None:
            self.stream_bw_mbps_min = round(bw_min, 3)
        return manifest, missing_pre, errors

    def _push_one(self, reg: _Registration, version: int,
                  buffer: np.ndarray, watermark=None,
                  ranges: list[tuple[int, int]] | None = None,
                  ) -> tuple[list[tuple[int, int]], bool]:
        """One push attempt: prepare/arm, fan the wire over N streams each
        under its own bandwidth-keyed deadline, then the verify handshake.
        Returns ``(missing, rejected)``: ``([], _)`` on a verified install;
        otherwise the merged ranges to resume — the failed streams' full
        assignments plus whatever the receiver's digest/gap check rejected
        — with ``rejected`` True only when the RECEIVER rejected bytes the
        sender believed landed. Raises on transport failure (every stream
        failed, control channel dead, ...)."""
        cfg = self.cfg
        with self._cv:
            self._round_counter += 1
            round_id = self._round_counter
        streamed = watermark is not None
        # sharded fan-out applies to full packed rounds; resumes carry the
        # failed ranges round-robin, and watermark rounds keep the STRIPE
        # interleave (a shard-grouped slab would idle every stream whose
        # slab the packer hadn't reached — the exact serialization the
        # stripe assignment exists to avoid)
        plan = None
        if ranges is None and not streamed:
            plan = self._stream_plan(reg)
        push_bytes = (sum(ln for _, ln in ranges) if ranges
                      else buffer.nbytes)
        deadline = cfg.push_deadline_s(push_bytes, streamed=streamed)
        with reg.lock:
            reg.ready.clear()
            reg.verify_evt.clear()
            reg.verify_msg = None
            prep = {"event": "prepare", "version": version,
                    "round": round_id}
            if ranges:
                # resume: the receiver keeps the superseded round's
                # coverage and clears only these ranges
                prep["resume"] = [[o, ln] for o, ln in ranges]
            _send_json(reg.sock, prep)
            if not reg.ready.wait(timeout=cfg.prepare_timeout_s):
                raise TimeoutError("receiver did not arm listeners")
            t0 = time.monotonic()
            if self.fault is not None:
                self.fault.note_attempt(reg.instance)
            batch = self.engine.transfer_submit_write(
                reg.host, reg.ports, buffer, round_id=round_id,
                watermark=watermark, ranges=ranges,
                gate_timeout_s=deadline + 1.0,
                fault=self.fault, instance=reg.instance,
                assignments=plan)
            manifest, missing_pre, errors = self._collect_streams(
                batch, t0, streamed)
            if errors and len(errors) == len(batch.futures):
                raise ConnectionError(
                    f"all {len(batch.futures)} streams failed: {errors[0]}")
            if (self.fault is not None
                    and self.fault.take_control_kill(reg.instance)):
                # chaos: control-plane death right before the verify
                # handshake — the receiver must reconnect, the retry
                # must re-push the round
                try:
                    reg.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            if cfg.verify:
                _send_json(reg.sock, {
                    "event": "verify", "round": round_id,
                    "version": version,
                    "manifest": [[o, ln, c] for o, ln, c in manifest],
                    # receiver-side completion wait for straggler frames
                    # still in the kernel after our futures resolved
                    "wait_s": min(30.0, deadline),
                })
                evt_deadline = time.monotonic() + deadline + 30.0
                while not reg.verify_evt.wait(timeout=0.2):
                    if self._stop.is_set():
                        raise ConnectionError("sender stopping")
                    with self._regs_lock:
                        lost = self._regs.get(reg.instance) is not reg
                    if lost:
                        # the receiver's control channel closed: no
                        # verify answer can come
                        raise ConnectionError("receiver registration lost")
                    if time.monotonic() > evt_deadline:
                        raise TimeoutError(
                            "receiver never answered verify")
                vr = reg.verify_msg or {}
                if int(vr.get("round", -1)) != round_id:
                    raise ConnectionError("verify result round mismatch")
                if vr.get("ok"):
                    # full coverage verified — even a timed-out stream's
                    # bytes landed and digest-checked (the receiver has
                    # already installed the version; treat as success)
                    missing = []
                    missing_pre = []
                    errors = []
                else:
                    missing = [(int(o), int(ln))
                               for o, ln in vr.get("missing") or []]
                    if not missing and not missing_pre:
                        raise ConnectionError(
                            "verify failed without resumable ranges: "
                            f"{vr.get('error')}")
            else:
                if errors:
                    # the trusting path has no verify round to scope a
                    # partial resume — a lost stream fails the attempt
                    raise ConnectionError(
                        f"{len(errors)} streams failed: {errors[0]}")
                # trusting path: bare completion installs the version
                _send_json(reg.sock, {"event": "transfer_done",
                                      "status": "success",
                                      "version": version})
                missing = []
            dt = time.monotonic() - t0
        if errors:
            # individual stream failures become a partial resume instead
            # of a full re-push: only those streams' ranges return
            self.stream_resumes += len(errors)
            self._note_health(reg.instance,
                              inc={"stream_resumes": len(errors)})
        if missing or missing_pre:
            rejected = bool(missing) and not errors
            return _merge_ranges(missing + missing_pre), rejected
        if ranges:
            resumed = sum(ln for _, ln in ranges)
            self.resumed_bytes += resumed
            self._note_health(reg.instance, inc={"resumed_bytes": resumed})
        if plan is not None:
            self.reshard_bytes += reg.reshard_total
        self.rounds_verified += 1
        if reg.pushed_version < 0:
            self.catchup_pushes += 1
        reg.pushed_version = version
        with self._regs_lock:
            self._escalated.pop(reg.instance, None)
        self._note_health(reg.instance, pushed_version=version,
                          last_push_s=round(dt, 4), escalated=False)
        self.round_log.append({"instance": reg.instance, "version": version,
                               "push_s": dt, "bytes": int(push_bytes),
                               "resumed": bool(ranges)})
        del self.round_log[:-64]
        mbps = push_bytes / max(dt, 1e-9) / 1e6
        # per-instance push duration distribution: one slow receiver
        # (bad NIC, busy engine) shows up as a p99/max outlier that the
        # fleet-wide MB/s mean would average away
        obs.observe("transfer/push_s", dt)
        log.info("pushed v%d to %s: %.0f MB/s over %d stream(s)%s", version,
                 reg.instance, mbps, max(1, self.push_streams),
                 " (resume)" if ranges else "")
        if self.manager is not None:
            # async notify so the instance rejoins the pool without the
            # trainer's next pack blocking on the engine's weight load
            # (sender_agent.py:617-624)
            self._notify_pool.submit(
                self.manager.update_weights, [reg.instance], version)
        return [], False


class SenderGroup:
    """N sender agents, one per local NIC, sharing one packed buffer.

    The reference fans each trainer's weight push over
    ``num_mooncake_groups_per_sender`` engine groups bound to different
    node IPs (config.toml:19-20, fsdp_interface.py:97-138) so an 8B push
    saturates aggregate NIC bandwidth, not one interface. Here each group
    is a full :class:`SenderAgent` (own control endpoint + TCP engine
    source-bound to its NIC); the MANAGER partitions rollout instances
    across the groups when all endpoints are registered via
    ``PUT /update_weight_senders`` — per-group work is 1/N of the pool.

    The buffer is shared read-only during pushes; trainer-side mutation
    (``signal_update`` / ``swap_buffer`` / ``buffer_write_lock``) fans out
    to every agent so each agent's (buffer, version) snapshot invariant is
    preserved independently.
    """

    def __init__(self, buffer: np.ndarray, sender_ips: list[str],
                 manager_client=None, num_streams: int = 4,
                 poll_s: float = 1.0, listen_host: str = "0.0.0.0",
                 cfg: TransferConfig | None = None, fault=None,
                 layout: ParamLayout | None = None, trainer_spec=None):
        if not sender_ips:
            raise ValueError("SenderGroup needs at least one sender IP")
        self.manager = manager_client
        self.senders = [
            SenderAgent(buffer, manager_client=manager_client,
                        listen_host=listen_host, num_streams=num_streams,
                        poll_s=poll_s, advertise_host=ip, bind_host=ip,
                        cfg=cfg, fault=fault, layout=layout,
                        trainer_spec=trainer_spec)
            for ip in sender_ips
        ]

    @property
    def laggard_cb(self):
        return self.senders[0].laggard_cb

    @laggard_cb.setter
    def laggard_cb(self, cb) -> None:
        for s in self.senders:
            s.laggard_cb = cb

    def counters(self) -> dict[str, float]:
        """Fleet-summed ``transfer/*`` gauges across the per-NIC agents."""
        out: dict[str, float] = {}
        for s in self.senders:
            for k, v in s.counters().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def sync_health(self) -> dict[str, dict]:
        """Per-instance health; the manager partitions instances across
        the groups, so the per-agent dicts are disjoint by construction."""
        out: dict[str, dict] = {}
        for s in self.senders:
            out.update(s.sync_health())
        return out

    @property
    def endpoints(self) -> list[str]:
        return [s.endpoint for s in self.senders]

    @property
    def version(self) -> int:
        return self.senders[0].version

    @property
    def buffer(self) -> np.ndarray:
        return self.senders[0].buffer

    def mark_push_failed(self, version: int) -> None:
        for s in self.senders:
            s.mark_push_failed(version)

    def start(self) -> None:
        for s in self.senders:
            s.start()

    def stop(self) -> None:
        for s in self.senders:
            s.stop()

    def signal_update(self, version: int | None = None) -> int:
        v = self.senders[0].signal_update(version)
        for s in self.senders[1:]:
            s.signal_update(v)
        return v

    def swap_buffer(self, new_buffer: np.ndarray, version: int) -> np.ndarray:
        old = self.senders[0].swap_buffer(new_buffer, version)
        for s in self.senders[1:]:
            s.swap_buffer(new_buffer, version)
        return old

    @contextlib.contextmanager
    def buffer_write_lock(self):
        """All-agents pack guard (no push round may be in flight on ANY
        NIC while the shared buffer is rewritten in place)."""
        with contextlib.ExitStack() as stack:
            for s in self.senders:
                stack.enter_context(s.buffer_write_lock())
            yield


def _split(endpoint: str) -> tuple[str, int]:
    host, port = endpoint.rsplit(":", 1)
    return host, int(port)


def _advertise_ip() -> str:
    from .nic import default_route_ip

    return default_route_ip()
