"""Multi-stream TCP bulk transfer engine (a copy of
``polyrl_tpu/transfer/tcp_engine.py``).

Counterpart of the reference's TCPTransferEngine
(rlboost/weight_transfer/transfer_engine.py:14-274): N parallel TCP streams
per transfer, 16-byte (offset, length) header per stream, receiver
``recv_into`` directly into a registered buffer memoryview (zero-copy), and
an async submit/poll API. Hardware-agnostic: the trainer-to-server path
between processes or hosts.

Integrity: every frame's
payload is followed by a 4-byte CRC32 trailer computed over the TRUE source
bytes. The receiver verifies it incrementally as bytes land; a mismatching
frame is rejected — its bytes are dropped from the coverage ledger so the
round's control-channel verify step demands a re-push of exactly that
range. ``transfer_submit_write`` returns the per-frame (offset, length,
crc) manifest through ``TransferBatch.result`` so the sender can ship it
on the control channel for the receiver's authoritative whole-round check.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

SOCK_BUF = 16 * 1024 * 1024  # 16 MB socket buffers (transfer_engine.py:40-42)
SEND_CHUNK = 64 * 1024 * 1024  # 64 MB send chunks
# streamed (watermark) mode: round-robin stripe per stream — small enough
# that every stream's next needed byte stays within n_streams*STRIPE of the
# packer (all streams active the whole round), big enough to amortize frames
STREAM_STRIPE = 16 * 1024 * 1024
HEADER = struct.Struct("<QQQQ")  # (round_id, offset, length, total_streams)
FOOTER = struct.Struct("<I")     # per-frame payload CRC32 trailer


def _tune(sock: socket.socket) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCK_BUF)
    except OSError:
        pass


class Watermark:
    """Progress gate for streaming a buffer that is still being packed.

    The packer advances the high-water mark as bytes [0, value) become
    valid; sender streams block before sending past it. This is what
    overlaps pack -> wire -> install inside ONE push round (the reference's
    sender pipeline, sender_agent.py:567-647) — the double-buffer only
    overlaps a pack with the PREVIOUS round."""

    def __init__(self, total: int):
        self.total = int(total)
        self._value = 0
        self._failed: str | None = None
        self._cv = threading.Condition()

    @property
    def value(self) -> int:
        with self._cv:
            return self._value

    def advance(self, new_value: int) -> None:
        with self._cv:
            if new_value > self._value:
                self._value = new_value
                self._cv.notify_all()

    def finish(self) -> None:
        self.advance(self.total)

    def fail(self, msg: str) -> None:
        with self._cv:
            self._failed = msg or "pack failed"
            self._cv.notify_all()

    def wait_until(self, target: int, timeout: float = 3600.0) -> None:
        # default budget matches the sender's streamed-round cap; callers
        # with a bandwidth-keyed round deadline pass it through so a dead
        # pack can never pin a sender thread for the full hour
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._value < target and self._failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"watermark stalled at {self._value}/{target}")
                self._cv.wait(min(left, 1.0))
            if self._failed is not None:
                raise ConnectionError(f"streamed pack failed: {self._failed}")


def split_ranges(total: int, n: int) -> list[tuple[int, int]]:
    """Split [0, total) into <=n contiguous (offset, length) ranges."""
    n = max(1, min(n, total)) if total else 1
    base, rem = divmod(total, n)
    out, off = [], 0
    for i in range(n):
        ln = base + (1 if i < rem else 0)
        if ln:
            out.append((off, ln))
        off += ln
    return out


class ReceiverSockets:
    """N listener sockets writing incoming streams straight into a buffer.

    Accept loops are persistent (one thread per listener, started once):
    each transfer round carries a round_id in the stream header, and
    connections from an aborted earlier round are rejected by id — so a
    failed round can never corrupt the accounting of the next one.
    """

    def __init__(self, buffer, num_streams: int, host: str = "0.0.0.0"):
        self._mv = memoryview(buffer).cast("B")
        self._socks: list[socket.socket] = []
        self._done = threading.Event()
        self._errors: list[str] = []
        self._completed = 0
        self._expected: int | None = None
        self._round = -1
        self._progress: dict[int, int] = {}  # range offset -> bytes landed
        self._conns: dict[int, list] = {}  # round -> live data connections
        self._lock = threading.Lock()
        self._closed = False
        # integrity ledger: frames whose CRC32 trailer mismatched are
        # rejected (their bytes dropped from the coverage so the round's
        # verify step demands a re-push); cumulative counter for telemetry
        self.crc_failures = 0
        self._resume = False  # current round re-pushes ranges of the prior
        self.ports: list[int] = []
        for _ in range(num_streams):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            _tune(s)
            s.bind((host, 0))
            s.listen(4)
            self._socks.append(s)
            self.ports.append(s.getsockname()[1])
        self._threads = [
            threading.Thread(target=self._serve_loop, args=(s,), daemon=True)
            for s in self._socks
        ]
        for t in self._threads:
            t.start()

    def arm(self, round_id: int, reset: bool = True,
            clear: list[tuple[int, int]] | None = None) -> None:
        """Begin accepting one transfer round tagged ``round_id``.

        ``reset=False`` arms a RESUME round: the coverage ledger of the
        superseded round is kept (its landed, CRC-verified bytes stay
        valid — same version, byte-identical source) and only the
        ``clear`` ranges about to be re-pushed are dropped, so a partial
        re-push completes the round instead of restarting it."""
        with self._lock:
            self._round = round_id
            self._completed = 0
            self._expected: int | None = None
            if reset:
                self._progress = {}
            elif clear:
                for off, _length in clear:
                    self._progress.pop(int(off), None)
            self._resume = not reset
            self._errors.clear()
            self._done.clear()
            # force-close dangling streams from older rounds: their header
            # passed the round check back then, so their recv loops would
            # keep writing stale bytes into the buffer UNDER the new round
            stale = [c for r, conns in self._conns.items()
                     if r != round_id for c in conns]
            self._conns = {round_id: self._conns.get(round_id, [])}
        for c in stale:
            try:
                # shutdown (NOT close) wakes a recv_into blocked in the
                # kernel; the owning serve thread's `with conn:` does the
                # close — closing here would free the fd number for a new
                # accept while the serve thread could still recv on it
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _serve_loop(self, listener: socket.socket) -> None:
        while not self._closed:
            try:
                conn, _ = listener.accept()
            except OSError:
                return  # closed
            round_id = None
            try:
                with conn:
                    _tune(conn)
                    hdr = self._recv_header(conn, first=True)
                    if hdr is None:
                        raise ConnectionError("eof in header")
                    round_id, offset, length, nstreams = hdr
                    with self._lock:
                        if round_id != self._round:
                            continue  # stale stream from an aborted round
                        self._expected = nstreams
                        self._conns.setdefault(round_id, []).append(conn)
                    # a stream is a SEQUENCE of (offset, length) framed
                    # ranges (streamed mode interleaves round-robin stripes
                    # so every stream trails the packer; serial mode sends
                    # exactly one contiguous range). Clean EOF at a frame
                    # boundary terminates the stream.
                    while True:
                        view = self._mv[offset : offset + length]
                        got = 0
                        crc = 0
                        while got < length:
                            n = conn.recv_into(view[got:],
                                               min(length - got, SOCK_BUF))
                            if n == 0:
                                raise ConnectionError(
                                    f"eof at {got}/{length}")
                            crc = zlib.crc32(view[got:got + n], crc)
                            got += n
                            with self._lock:
                                if round_id == self._round:
                                    self._progress[offset] = got
                        want = FOOTER.unpack(
                            self._recv_exact(conn, FOOTER.size))[0]
                        if want != crc:
                            # integrity: reject the frame — its bytes are
                            # dropped from the coverage ledger so the
                            # verify step demands a re-push of exactly
                            # this range. The stream itself stays healthy
                            # (framing is intact), so later frames land.
                            with self._lock:
                                if round_id == self._round:
                                    self.crc_failures += 1
                                    self._progress.pop(offset, None)
                        hdr = self._recv_header(conn, first=False)
                        if hdr is None:
                            break  # clean EOF: stream complete
                        r2, offset, length, _ = hdr
                        if r2 != round_id:
                            raise ConnectionError(
                                "round id changed mid-stream")
                        if length == 0:
                            break
                    with self._lock:
                        if round_id != self._round:
                            continue
                        self._completed += 1
                        if self._completed == self._expected:
                            self._done.set()
            except Exception as exc:  # noqa: BLE001 — reported to waiter
                with self._lock:
                    # only fail the round this stream belongs to — a dangling
                    # connection from an aborted round must not poison the
                    # retry's accounting
                    if round_id == self._round:
                        self._errors.append(str(exc))
                        self._done.set()

    @staticmethod
    def _recv_header(conn: socket.socket, first: bool):
        """Read one frame header; None on clean EOF at the boundary (only
        legal between frames — ``first=True`` treats it as an error)."""
        hdr = b""
        while len(hdr) < HEADER.size:
            chunk = conn.recv(HEADER.size - len(hdr))
            if not chunk:
                if hdr or first:
                    raise ConnectionError(
                        f"eof mid-header ({len(hdr)}/{HEADER.size})")
                return None
            hdr += chunk
        return HEADER.unpack(hdr)

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError(
                    f"eof mid-frame-trailer ({len(buf)}/{n})")
            buf += chunk
        return buf

    def coverage(self) -> list[tuple[int, int]]:
        """Snapshot of (range_offset, bytes_landed) for the armed round —
        the receive-side watermark an incremental installer polls."""
        with self._lock:
            return sorted(self._progress.items())

    def _merged(self) -> list[list[int]]:
        """Merged [lo, hi) covered intervals (caller holds ``_lock``)."""
        merged: list[list[int]] = []
        for off, got in sorted(self._progress.items()):
            if got <= 0:
                continue
            if merged and off <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], off + got)
            else:
                merged.append([off, off + got])
        return merged

    def gaps(self, total: int) -> list[tuple[int, int]]:
        """Uncovered (offset, length) holes of [0, total) in the armed
        round's ledger — what a partial re-push must still deliver."""
        with self._lock:
            merged = self._merged()
        out: list[tuple[int, int]] = []
        pos = 0
        for lo, hi in merged:
            if lo > pos:
                out.append((pos, lo - pos))
            pos = max(pos, hi)
        if pos < total:
            out.append((pos, total - pos))
        return out

    def verify_ranges(self, manifest) -> list[tuple[int, int]]:
        """Manifest entries ``(offset, length, crc32)`` that did NOT land
        intact: not fully covered by the ledger, or the buffer bytes'
        recomputed CRC mismatches the sender's digest. This is the
        receiver's authoritative whole-round check — the per-frame trailer
        already rejected corrupt frames at land time; this re-derivation
        from the buffer catches anything that slipped past it (torn
        writes, a stale stream, a frame the trailer happened to match)."""
        with self._lock:
            merged = self._merged()
        bad: list[tuple[int, int]] = []
        for off, length, want in manifest:
            off, length, want = int(off), int(length), int(want)
            covered = any(lo <= off and off + length <= hi
                          for lo, hi in merged)
            if not covered or zlib.crc32(
                    self._mv[off:off + length]) != want:
                bad.append((off, length))
        return bad

    @property
    def resume_round(self) -> bool:
        """True while the armed round is a partial re-push."""
        with self._lock:
            return self._resume

    def wait_done(self, timeout: float | None = None) -> bool:
        """Non-raising completion wait: True once every expected stream of
        the armed round terminated (cleanly or with an error). The verify
        step reads the ledger either way — a dead stream is just a gap."""
        return self._done.wait(timeout)

    def wait(self, timeout: float | None = None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError("transfer receive timed out")
        with self._lock:
            if self._errors:
                raise ConnectionError("; ".join(self._errors))

    def close(self) -> None:
        self._closed = True
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


@dataclass
class TransferBatch:
    futures: list[Future] = field(default_factory=list)
    # per-stream (offset, length) lists, index-aligned with ``futures`` —
    # the sharded push reads these to scope a failed stream's re-push to
    # exactly the ranges that stream owned
    assignments: list[list[tuple[int, int]]] = field(default_factory=list)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)

    def result(self, timeout: float | None = None) -> list[tuple[int, int, int]]:
        """Wait for every stream; returns the round's frame manifest —
        ``(offset, length, crc32)`` per frame actually sent — which the
        sender ships on the control channel for receiver-side verify."""
        manifest: list[tuple[int, int, int]] = []
        for f in self.futures:
            manifest.extend(f.result(timeout) or [])
        return manifest


class TcpTransferEngine:
    """Sender side: fan a buffer out over N parallel streams.

    ``bind_host`` pins the outbound streams' SOURCE address to one local
    interface — multi-NIC hosts run one engine per NIC so sender groups
    aggregate bandwidth instead of sharing the default route (reference
    per-group local_hostname, fsdp_interface.py:118-126)."""

    def __init__(self, num_streams: int = 8, workers: int | None = None,
                 bind_host: str | None = None):
        self.num_streams = num_streams
        self.bind_host = bind_host
        self._pool = ThreadPoolExecutor(max_workers=workers or num_streams)

    def _send_ranges(self, host: str, port: int, mv: memoryview,
                     round_id: int, ranges: list[tuple[int, int]],
                     nstreams: int,
                     watermark: "Watermark | None" = None,
                     gate_timeout_s: float | None = None,
                     fault=None, instance: str = "",
                     stream_idx: int = 0) -> list[tuple[int, int, int]]:
        """One stream = one connection carrying a sequence of framed
        (offset, length) ranges; closing the connection at a frame boundary
        terminates the stream (ReceiverSockets._serve_loop). Each frame's
        payload is followed by a CRC32 trailer over the TRUE source bytes
        (computed before any injected wire corruption, so a corrupted
        payload is detectable). Returns this stream's frame manifest."""
        src = (self.bind_host, 0) if self.bind_host else None
        # smaller chunks under a watermark: the gate advances per packed
        # tensor group, and a 64 MB chunk would add that much latency to
        # every gate crossing
        chunk = SEND_CHUNK if watermark is None else SOCK_BUF
        manifest: list[tuple[int, int, int]] = []
        with socket.create_connection((host, port), timeout=60.0,
                                      source_address=src) as s:
            _tune(s)
            if fault is not None:
                # transfer-plane chaos: a stalled stream blows the round
                # past its bandwidth-keyed deadline (rollout/faults.py)
                fault.maybe_stall(instance, stream_idx)
            for offset, length in ranges:
                s.sendall(HEADER.pack(round_id, offset, length, nstreams))
                corrupt = (fault is not None
                           and fault.take_corruption(instance, stream_idx))
                end = offset + length
                pos = offset
                crc = 0
                while pos < end:
                    nxt = min(pos + chunk, end)
                    if watermark is not None:
                        watermark.wait_until(
                            nxt, timeout=gate_timeout_s or 3600.0)
                    payload = mv[pos:nxt]
                    crc = zlib.crc32(payload, crc)  # TRUE bytes, pre-fault
                    if corrupt:
                        bad = bytearray(payload)
                        bad[0] ^= 0xFF
                        payload = bytes(bad)
                        corrupt = False  # one flipped chunk is enough
                    s.sendall(payload)
                    pos = nxt
                s.sendall(FOOTER.pack(crc))
                manifest.append((offset, length, crc))
        return manifest

    def transfer_submit_write(self, host: str, ports: list[int], buffer,
                              round_id: int = 0,
                              watermark: "Watermark | None" = None,
                              ranges: list[tuple[int, int]] | None = None,
                              gate_timeout_s: float | None = None,
                              fault=None, instance: str = "",
                              assignments: list[list[tuple[int, int]]]
                              | None = None,
                              ) -> TransferBatch:
        """Split ``buffer`` across ``ports`` and send concurrently.

        Serial mode: one contiguous range per stream (bandwidth-optimal for
        an already-packed buffer). Streamed (``watermark``) mode: STRIPE
        chunks assigned round-robin, so every stream works just behind the
        packer — contiguous ranges would leave stream k idle until the
        watermark crossed its start offset, serializing the round's wire
        behind pack order. Explicit ``ranges`` is the RESUME
        path: only the given (offset, length) ranges are sent, assigned
        round-robin across the streams — a post-``verify_failed`` re-push
        delivers the failed ranges without restarting the round. Explicit
        ``assignments`` is the SHARDED path (transfer/layout.py
        ReshardingMap.stream_assignments): stream i carries exactly
        ``assignments[i]`` — the caller owns the balance/affinity."""
        mv = memoryview(buffer).cast("B")
        batch = TransferBatch()
        if assignments is not None:
            assignments = [[(int(o), int(ln)) for o, ln in rs if int(ln) > 0]
                           for rs in assignments]
            assignments = [rs for rs in assignments if rs]
            if not assignments:
                assignments = [[(0, 0)]]
        elif ranges is not None:
            rs = [(int(o), int(ln)) for o, ln in ranges if int(ln) > 0]
            n_active = min(len(ports), len(rs)) or 1
            assignments = [c for c in
                           (rs[i::n_active] for i in range(n_active)) if c]
            if not assignments:
                assignments = [[(0, 0)]] if not rs else assignments
        elif watermark is None:
            assignments = [[r] for r in split_ranges(len(mv), len(ports))]
        else:
            total = len(mv)
            chunks = [(off, min(STREAM_STRIPE, total - off))
                      for off in range(0, total, STREAM_STRIPE)]
            n_active = min(len(ports), len(chunks)) or 1
            assignments = [c for c in
                           (chunks[i::n_active] for i in range(n_active))
                           if c]
        for i, (rngs, port) in enumerate(zip(assignments, ports)):
            batch.assignments.append(list(rngs))
            batch.futures.append(self._pool.submit(
                self._send_ranges, host, port, mv, round_id, rngs,
                len(assignments), watermark, gate_timeout_s, fault,
                instance, i))
        return batch

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
