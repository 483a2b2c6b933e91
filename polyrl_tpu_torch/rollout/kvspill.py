"""Host-RAM KV spill tier: the backing store behind the paged KV pool.

The port's counterpart of ``polyrl_tpu/rollout/kvspill.py``. The page
ledger (``rollout/kvledger.py``) knows which resident pages are cold and
who owns them; this tier pages cold, unreferenced, published prefix-cache
pages out to host memory: their physical pages return to the engine's
``PageAllocator`` and the KV survives on the host until a prefix-cache hit
restores it into a freshly allocated page, at a new physical index, which
is safe because every consumer reads through the page table.

Where the JAX tier runs a copy thread around a blocking ``device_get``,
this one runs on a CUDA copy stream, and the host never waits on a copy:

- The engine gathers the pages on its compute stream, page-major
  (``[n, 2L, Hkv, page_size, D]``: K of every layer, then V), queued behind
  the dispatches already in flight. :meth:`spill` records an event after
  the gather; the copy stream waits on it and copies each page into its own
  pinned host buffer. The gathered tensor is marked ``record_stream(copy
  stream)``, so the caching allocator does not hand its memory to a later
  kernel while the copy still reads it. An event recorded after the copies
  marks the batch landed; at most ``lane_depth`` batches are in flight,
  which bounds the device memory they pin. With the lane full
  :meth:`lane_free` says no (and counts it, ``lane_full``) and the engine
  spills nothing, as the JAX engine does: the sweep waits for a later
  dispatch, allocation pressure evicts.
- The engine frees the physical pages right after the gather: a later
  prefill that writes them is queued on the compute stream, after it.
- :meth:`load` queues the host-to-device copies of pages into a device
  tensor on the current (compute) stream, which first waits on each batch's
  landed event: a restore that beats the copy is ordered on the device,
  where the JAX tier falls back to a synchronous ``device_get``. An
  event recorded after these copies is kept with each buffer; :meth:`drop`
  returns buffers to the free list, and a later spill into a buffer makes
  the copy stream wait on that event first, so a restore's copy still in
  flight never reads a buffer being overwritten.
- Pinned buffers (one per page) are allocated lazily, up to
  ``capacity_bytes`` of resident pages, and reused. On the card a buffer is
  pinned or the allocation raises; on a CPU device buffers are ordinary
  host tensors and every copy is synchronous.
- Each batch's copies are timed on the device, by events recorded around
  them (the wall on the CPU): ``d2h_s`` from the gather's end to the batch
  landed, ``h2d_s`` over a restore's host-to-device copies. Over
  ``bytes_spilled`` and ``bytes_restored`` they give the copy rates of the
  spills and restores that traffic caused.

The ledger owns the page counters that feed ``kv_spilled_frac`` and the
reconciliation; this pool reports host-side truth (:meth:`stats`).

A ``HostSpillPool`` is one copy lane: one device, its copy stream, its
events, its pinned buffers and its batches in flight. An engine of ``tp``
shards (``CBEngine(tp=)``) holds a :class:`ShardedSpillPool`: one lane a
shard, on the shard's device, whether the shards sit on several cards or
share one. Each shard gathers its own pools' rows of the spilled pages on
its device (``[n, 2L, Hkv/tp, page_size, D]``) and its lane copies them;
a handle stands for every shard's part of a page, a restore copies each
part back on its shard's device behind its own lane's landed event. A
page is still one page across the shards: the ledger's counters do not
change, and the capacity and the stats count a page's bytes over every
shard.

Thread-safety: ``spill``/``load``/``drop`` run on the engine loop thread;
``stats`` may be read from any thread; one lock guards the bookkeeping.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch


@dataclasses.dataclass
class _Buffer:
    host: torch.Tensor  # one page: [2L, Hkv, page_size, D]
    # the last host-to-device copy reading it (compute stream), or None
    read: "torch.cuda.Event | None" = None


@dataclasses.dataclass
class _SpillEntry:
    handle: int
    nbytes: int
    buf: _Buffer
    # the batch's device-to-host copy (copy stream); None on the CPU
    landed: "torch.cuda.Event | None" = None


class HostSpillPool:
    """Pinned host-memory backing tier for spilled KV pages."""

    def __init__(self, capacity_bytes: int, device, lane_depth: int = 2):
        self.capacity_bytes = int(capacity_bytes)
        self.device = torch.device(device)
        self.lane_depth = max(1, int(lane_depth))
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._lock = threading.Lock()
        self._entries: dict[int, _SpillEntry] = {}
        self._free: list[_Buffer] = []
        # landed events of the batches whose copy may still run, oldest
        # first (the copy stream completes them in order)
        self._lane: collections.deque = collections.deque()
        self._next_handle = 0
        # host-side truth (cumulative; the ledger owns the page counters)
        self.pinned_bytes = 0  # host bytes of every buffer allocated
        self.resident_bytes = 0
        self.bytes_spilled = 0
        self.bytes_restored = 0
        self.copy_batches = 0
        self.restores_behind_copy = 0  # restored pages whose copy had not landed
        self.lane_full = 0  # spills refused because the copy lane was full
        self.d2h_s = 0.0  # device seconds of the spills' copies
        self.h2d_s = 0.0  # device seconds of the restores' copies
        # (attribute, start event, end event) not yet completed
        self._timed: list = []

    # -- lifecycle -----------------------------------------------------------

    def synchronize(self) -> None:
        """Wait for the copies queued on the copy stream."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()

    def stop(self) -> None:
        """Wait for the copies in flight and release the free buffers
        (entries still resident keep theirs)."""
        self.synchronize()
        with self._lock:
            self._settle_times()
            self._lane.clear()
            for b in self._free:
                self.pinned_bytes -= b.host.numel() * b.host.element_size()
            self._free.clear()

    # -- spill side (engine loop thread) -------------------------------------

    def _inflight(self) -> int:
        """Batches whose copy has not landed (under the lock)."""
        while self._lane and self._lane[0].query():
            self._lane.popleft()
        self._settle_times()
        return len(self._lane)

    def _settle_times(self) -> None:
        """Fold the completed copies' device seconds in (under the lock)."""
        left = []
        for attr, start, end in self._timed:
            if end.query():
                setattr(self, attr, getattr(self, attr)
                        + start.elapsed_time(end) / 1e3)
            else:
                left.append((attr, start, end))
        self._timed = left

    def inflight(self) -> int:
        """Batches whose copy has not landed."""
        with self._lock:
            return self._inflight()

    def lane_free(self) -> bool:
        """Backpressure: fewer than ``lane_depth`` batches in flight (a full
        lane means the copies are behind: the engine spills nothing this
        time rather than pin more device memory)."""
        with self._lock:
            free = self._inflight() < self.lane_depth
            if not free:
                self.lane_full += 1
            return free

    def can_spill(self, n_pages: int, page_bytes: int) -> bool:
        with self._lock:
            return (self._inflight() < self.lane_depth
                    and self.resident_bytes + n_pages * page_bytes
                    <= self.capacity_bytes)

    def _take_buffer(self, like: torch.Tensor) -> _Buffer:
        """A free buffer for one page shaped as ``like``, or a new one
        (under the lock)."""
        if self._free:
            return self._free.pop()
        host = torch.empty(like.shape, dtype=like.dtype, pin_memory=self._cuda)
        self.pinned_bytes += host.numel() * host.element_size()
        return _Buffer(host)

    def spill(self, kv: torch.Tensor, page_bytes: int) -> list[int]:
        """Copy ``kv`` (``[n, 2L, Hkv, page_size, D]``, gathered on the
        current stream) to host buffers, one page each, on the copy stream;
        returns one handle per page (page ``i`` of ``kv`` <-> handle
        ``i``)."""
        n = kv.shape[0]
        with self._lock:
            bufs = [self._take_buffer(kv[0]) for _ in range(n)]
        landed = None
        if self._cuda:
            gathered = torch.cuda.Event(enable_timing=True)
            gathered.record(torch.cuda.current_stream(self.device))
            cs = self._copy_stream
            cs.wait_event(gathered)
            with torch.cuda.stream(cs):
                for b, page in zip(bufs, kv):
                    if b.read is not None:
                        cs.wait_event(b.read)  # a restore still reading it
                    b.host.copy_(page, non_blocking=True)
                landed = torch.cuda.Event(enable_timing=True)
                landed.record(cs)
            # the allocator must not reuse kv's memory before the copies
            kv.record_stream(cs)
        else:
            t0 = time.perf_counter()
            for b, page in zip(bufs, kv):
                b.host.copy_(page)
            dt = time.perf_counter() - t0
        handles: list[int] = []
        with self._lock:
            for b in bufs:
                h = self._next_handle
                self._next_handle += 1
                self._entries[h] = _SpillEntry(h, int(page_bytes), b, landed)
                handles.append(h)
            if landed is not None:
                self._lane.append(landed)
                self._timed.append(("d2h_s", gathered, landed))
            else:
                self.d2h_s += dt
            self.resident_bytes += n * int(page_bytes)
            self.bytes_spilled += n * int(page_bytes)
            self.copy_batches += 1
        return handles

    # -- restore / drop side (engine loop thread) -----------------------------

    def load(self, handles, out: torch.Tensor) -> list[bool]:
        """Queue the copy of each handle's page into ``out[i]`` (a device
        tensor ``[n, 2L, Hkv, page_size, D]``) on the current stream,
        ordered after the page's own device-to-host copy. Returns, for
        each page, whether its copy had not landed yet."""
        with self._lock:
            entries = [self._entries[h] for h in handles]
        if not self._cuda:
            t0 = time.perf_counter()
            for i, e in enumerate(entries):
                out[i].copy_(e.buf.host)
            dt = time.perf_counter() - t0
            with self._lock:
                self.h2d_s += dt
            return [False] * len(entries)
        stream = torch.cuda.current_stream(self.device)
        waited: set[int] = set()
        flags = [e.landed is not None and not e.landed.query()
                 for e in entries]
        behind = sum(flags)
        for e, late in zip(entries, flags):
            if late and id(e.landed) not in waited:
                waited.add(id(e.landed))
                stream.wait_event(e.landed)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for i, e in enumerate(entries):
            out[i].copy_(e.buf.host, non_blocking=True)
        read = torch.cuda.Event(enable_timing=True)
        read.record(stream)
        with self._lock:
            for e in entries:
                e.buf.read = read
            self.restores_behind_copy += behind
            self._settle_times()
            self._timed.append(("h2d_s", start, read))
        return flags

    def drop(self, handles, restored: bool = False) -> None:
        """Discard entries: a restore consumed them (``restored=True``,
        bytes move to the restored counter) or the content died while
        spilled (abort, cache flush, weight swap: both tiers freed). Their
        buffers go back to the free list."""
        with self._lock:
            for h in handles:
                e = self._entries.pop(h, None)
                if e is None:
                    continue
                self._free.append(e.buf)
                self.resident_bytes -= e.nbytes
                if restored:
                    self.bytes_restored += e.nbytes

    # -- views ----------------------------------------------------------------

    @property
    def resident_pages(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        """Host-side truth (the ``memory.spill.host`` block); the copy
        seconds count the copies completed so far."""
        with self._lock:
            self._settle_times()
            return {
                "resident_pages": len(self._entries),
                "resident_bytes": int(self.resident_bytes),
                "capacity_bytes": int(self.capacity_bytes),
                "pinned_bytes": int(self.pinned_bytes),
                "bytes_spilled": int(self.bytes_spilled),
                "bytes_restored": int(self.bytes_restored),
                "copy_batches": int(self.copy_batches),
                "restores_behind_copy": int(self.restores_behind_copy),
                "lane_inflight": self._inflight(),
                "lane_depth": self.lane_depth,
                "lane_full": int(self.lane_full),
                "d2h_s": float(self.d2h_s),
                "h2d_s": float(self.h2d_s),
            }


# stats() fields summed over a sharded pool's lanes (a page's bytes on
# every shard, and the device seconds of every lane's copies)
_SUMMED = ("pinned_bytes", "resident_bytes", "bytes_spilled",
           "bytes_restored", "d2h_s", "h2d_s")


class ShardedSpillPool:
    """The spill tier of a tp engine: one :class:`HostSpillPool` lane a
    shard, each on its shard's device, behind one handle a page.

    ``spill`` takes every shard's gathered part of the same pages (one
    ``[n, 2L, Hkv/tp, page_size, D]`` tensor a shard, on its device) and
    each lane copies its own; ``load`` takes one staging tensor a shard.
    The lanes keep a page's part each, ``page_bytes / tp`` bytes; the
    capacity, the backpressure and the counters are the tier's: a page
    fits if every shard's part fits, the tier spills only when every lane
    is free, and ``stats()`` keeps ``HostSpillPool``'s fields (bytes and
    device seconds summed over the lanes, pages and batches counted once)
    with each lane's own under ``lanes``."""

    def __init__(self, capacity_bytes: int, devices, lane_depth: int = 2):
        self.capacity_bytes = int(capacity_bytes)
        self.lanes = [HostSpillPool(capacity_bytes, d, lane_depth)
                      for d in devices]
        self.lane_depth = self.lanes[0].lane_depth
        self._lock = threading.Lock()
        self._parts: dict[int, tuple] = {}  # handle -> each lane's handle
        self._next_handle = 0
        self.copy_batches = 0
        self.restores_behind_copy = 0
        self.lane_full = 0

    def synchronize(self) -> None:
        for lane in self.lanes:
            lane.synchronize()

    def stop(self) -> None:
        for lane in self.lanes:
            lane.stop()

    def _lanes_free(self) -> bool:
        return all(lane.inflight() < lane.lane_depth for lane in self.lanes)

    def lane_free(self) -> bool:
        """Every lane has fewer than ``lane_depth`` batches in flight (one
        full lane and the engine spills nothing, counted in ``lane_full``)."""
        free = self._lanes_free()
        if not free:
            with self._lock:
                self.lane_full += 1
        return free

    def can_spill(self, n_pages: int, page_bytes: int) -> bool:
        resident = sum(lane.resident_bytes for lane in self.lanes)
        return (self._lanes_free()
                and resident + n_pages * page_bytes <= self.capacity_bytes)

    def spill(self, parts: list, page_bytes: int) -> list[int]:
        """Each lane copies its shard's part (``parts[s]``, gathered on the
        shard's current stream); one handle a page."""
        part_bytes = int(page_bytes) // len(self.lanes)
        per_lane = [lane.spill(kv, part_bytes)
                    for lane, kv in zip(self.lanes, parts)]
        with self._lock:
            handles = []
            for hs in zip(*per_lane):
                h = self._next_handle
                self._next_handle += 1
                self._parts[h] = hs
                handles.append(h)
            self.copy_batches += 1
        return handles

    def load(self, handles, outs: list) -> list[bool]:
        """Queue each shard's parts into ``outs[s]`` on the shard's
        current stream, each behind its own lane's landed event."""
        with self._lock:
            parts = [self._parts[h] for h in handles]
        late = [False] * len(parts)
        for s, (lane, out) in enumerate(zip(self.lanes, outs)):
            flags = lane.load([p[s] for p in parts], out)
            late = [a or b for a, b in zip(late, flags)]
        with self._lock:
            self.restores_behind_copy += sum(late)
        return late

    def drop(self, handles, restored: bool = False) -> None:
        with self._lock:
            parts = [self._parts.pop(h) for h in handles if h in self._parts]
        for s, lane in enumerate(self.lanes):
            lane.drop([p[s] for p in parts], restored=restored)

    @property
    def resident_pages(self) -> int:
        with self._lock:
            return len(self._parts)

    def stats(self) -> dict:
        lanes = [lane.stats() for lane in self.lanes]
        out = {key: sum(ln[key] for ln in lanes) for key in _SUMMED}
        out.update(capacity_bytes=int(self.capacity_bytes),
                   lane_inflight=max(ln["lane_inflight"] for ln in lanes),
                   lane_depth=self.lane_depth, lanes=lanes)
        with self._lock:
            out.update(resident_pages=len(self._parts),
                       copy_batches=int(self.copy_batches),
                       restores_behind_copy=int(self.restores_behind_copy),
                       lane_full=int(self.lane_full))
        return out
