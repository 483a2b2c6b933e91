"""Flat parameter layout: name -> (shape, dtype, offset) over one buffer.

The port's copy of ``polyrl_tpu/transfer/layout.py``, byte for byte on the
wire: both packages push into each other's receivers, so leaf names, their
order, dtype names, offsets and the layout JSON are the reference's.

- Leaf names are the dotted dict keys (``layers.wq``), in the order in
  which ``jax.tree_util`` flattens a nested dict: keys sorted at every
  level. Leaves are torch tensors (any device, ``meta`` included: only the
  shape and dtype are read for a layout) or numpy arrays.
- dtype names are numpy's (``float32``, ``int8``), with ``bfloat16``
  written as such. numpy has no bf16 here, so a bf16 leaf is carried as
  raw 2-byte words (a torch ``.view(torch.uint8)`` of the tensor), never
  through a numpy bf16 dtype.
- Entries are laid out in that order, each at a 64-byte aligned offset.

Packing on the trainer goes device to host into one (pinned) uint8 host
buffer: ``pack_params_streaming`` issues every leaf's copy up front on a
side stream, one event per ~64 MB group, and advances the sender's
watermark as each group lands, so the wire starts before the pack ends.
Installing on the rollout server goes host to device, one entry at a time
as its bytes land (``make_incremental_installer``), into a staging tree on
the engine's device that the engine then copies into its live tensors in
place.

``build_resharding_map`` and ``ShardSpec`` (pure numpy) come with the
layout; the port's engines are unsharded, so their spec has one shard.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

ALIGN = 64

_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _TORCH_NAMES.items()}


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return _TORCH_NAMES[dt]
    return np.dtype(dt).name if not str(dt).startswith("bfloat16") else "bfloat16"


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a layout dtype name."""
    return _BY_NAME[name]


def flatten_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(dotted name, leaf)`` in ``jax.tree_util`` flatten order for nested
    dicts: keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_names(tree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], tree)]


def unflatten_names(named: dict[str, Any]) -> dict:
    """Nested dict from dotted names (the inverse of
    ``flatten_with_names``)."""
    root: dict = {}
    for name, leaf in named.items():
        *path, last = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root


@dataclass(frozen=True)
class Entry:
    name: str
    shape: tuple[int, ...]
    dtype: str  # numpy dtype name, or "bfloat16"
    offset: int
    nbytes: int


@dataclass(frozen=True)
class ParamLayout:
    entries: tuple[Entry, ...]
    total_bytes: int

    def by_name(self) -> dict[str, Entry]:
        return {e.name: e for e in self.entries}

    def to_json(self) -> str:
        return json.dumps({
            "total_bytes": self.total_bytes,
            "entries": [
                [e.name, list(e.shape), e.dtype, e.offset, e.nbytes]
                for e in self.entries
            ],
        })

    @staticmethod
    def from_json(s: str) -> "ParamLayout":
        d = json.loads(s)
        entries = tuple(
            Entry(n, tuple(sh), dt, off, nb) for n, sh, dt, off, nb in d["entries"]
        )
        return ParamLayout(entries, d["total_bytes"])


def build_layout(params: Any) -> ParamLayout:
    """The flat layout of a nested dict of tensors or arrays."""
    entries = []
    offset = 0
    for name, leaf in flatten_with_names(params):
        shape = tuple(int(s) for s in leaf.shape)
        dtype = _dtype_name(leaf.dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype)
        entries.append(Entry(name, shape, dtype, offset, nbytes))
        offset += (nbytes + ALIGN - 1) // ALIGN * ALIGN
    return ParamLayout(tuple(entries), offset)


def alloc_buffer(layout: ParamLayout, pin: bool = False) -> np.ndarray:
    """One contiguous zeroed uint8 host buffer for the whole layout. With
    ``pin`` (and a card present) it is page-locked: a numpy view of a
    pinned torch tensor, which the view keeps alive, so that device copies
    into and out of it run as DMA without a staging copy."""
    if pin and torch.cuda.is_available():
        t = torch.empty(layout.total_bytes, dtype=torch.uint8, pin_memory=True)
        t.zero_()
        return t.numpy()
    return np.zeros(layout.total_bytes, dtype=np.uint8)


def _on_card(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"


def _byte_view(leaf) -> torch.Tensor:
    """The leaf's bytes as a flat uint8 tensor on its own device."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def pack_params(params: Any, layout: ParamLayout, buffer: np.ndarray) -> None:
    """Copy every leaf into ``buffer`` at its layout offset (blocking)."""
    pack_params_streaming(params, layout, buffer, lambda _hw: None)


def pack_params_streaming(params: Any, layout: ParamLayout,
                          buffer: np.ndarray, progress,
                          group_bytes: int = 64 << 20,
                          ready: "torch.cuda.Event | None" = None) -> None:
    """Pack in layout order, calling ``progress(high_water_byte)`` after
    each ~``group_bytes`` group so that sender streams can trail the
    packer (one push round overlaps pack and wire).

    Leaves on the card are copied device to host on a side stream: every
    copy is issued up front (``non_blocking``, each group closed by an
    event), then the groups are waited on in order, so the copies stay
    bandwidth-bound. The side stream first waits on ``ready`` (an event
    the caller recorded after the work that produced ``params``, such as
    the trainer's clone of the tree), else on the caller's current stream,
    so the pack never reads a tensor still being written. Every event is
    waited on before this returns, so the caller may free ``params`` then.
    Host leaves are copied on the spot."""
    by_name = dict(flatten_with_names(params))
    dst = torch.from_numpy(buffer)
    groups: list[list[Entry]] = [[]]
    size = 0
    for e in layout.entries:
        groups[-1].append(e)
        size += e.nbytes
        if size >= group_bytes:
            groups.append([])
            size = 0
    card = [e for e in layout.entries if _on_card(by_name[e.name])]
    events: dict[int, torch.cuda.Event] = {}
    if card:
        dev = by_name[card[0].name].device
        stream = torch.cuda.Stream(device=dev)
        if ready is not None:
            stream.wait_event(ready)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for gi, group in enumerate(groups):
                for e in group:
                    if _on_card(by_name[e.name]):
                        dst[e.offset:e.offset + e.nbytes].copy_(
                            _byte_view(by_name[e.name]), non_blocking=True)
                events[gi] = torch.cuda.Event()
                events[gi].record(stream)
    for gi, group in enumerate(groups):
        for e in group:
            if not _on_card(by_name[e.name]):
                dst[e.offset:e.offset + e.nbytes].copy_(
                    _byte_view(by_name[e.name]))
        if gi in events:
            events[gi].synchronize()
        if group:
            progress(group[-1].offset + group[-1].nbytes)
    progress(layout.total_bytes)


def covered_entries(layout: ParamLayout, coverage, start_idx: int = 0,
                    limit: int | None = None):
    """Entries from ``start_idx`` whose bytes are fully landed, given
    receive-side ``coverage`` = sorted (range_offset, bytes_landed) pairs
    (ReceiverSockets.coverage()). Stops at the first incomplete entry so
    callers emit tensors strictly in layout order. ``limit`` caps the
    result (per-tensor install loops want just the next one)."""
    # landed prefixes of contiguous stream ranges: merge adjacent so an
    # entry spanning a range boundary is recognised once both sides land
    merged: list[list[int]] = []
    for off, got in coverage:
        if got <= 0:
            continue
        if merged and off <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], off + got)
        else:
            merged.append([off, off + got])
    out = []
    i = 0
    for e in layout.entries[start_idx:]:
        lo, hi = e.offset, e.offset + e.nbytes
        while i < len(merged) and merged[i][1] <= lo:
            i += 1
        if i < len(merged) and merged[i][0] <= lo and hi <= merged[i][1]:
            out.append(e)
            if limit is not None and len(out) >= limit:
                break
        else:
            break
    return out


def entry_tensor(entry: Entry, raw) -> torch.Tensor:
    """A host tensor of ``entry``'s dtype and shape viewing ``raw`` (the
    entry's bytes, a uint8 array or tensor) without a copy."""
    t = raw if isinstance(raw, torch.Tensor) else torch.from_numpy(
        np.asarray(raw))
    return t.view(torch_dtype(entry.dtype)).view(entry.shape)


def make_incremental_installer(layout: ParamLayout, device,
                               staging: dict | None = None,
                               after: "torch.cuda.Event | None" = None):
    """Build ``(install_fn, staging)`` for a streaming weight install:
    ``install_fn(entry, raw_bytes)`` copies one landed entry into the
    staging tensor of its name on ``device`` (allocated here, or reused
    from ``staging``, a ``{name: tensor}`` dict of an earlier install).

    On the card each copy runs on a side stream from the (pinned) receive
    buffer and is waited on before ``install_fn`` returns, since the
    receiver may reuse those bytes for the next round once it does; the
    side stream first waits on ``after`` (the event the engine recorded
    after its last copy out of ``staging``), so a new install never
    overwrites staging tensors still being read."""
    device = torch.device(device)
    staging = {} if staging is None else staging
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
    first = [True]

    def install(entry: Entry, raw) -> None:
        dst = staging.get(entry.name)
        if dst is None or tuple(dst.shape) != entry.shape:
            dst = staging[entry.name] = torch.empty(
                entry.shape, dtype=torch_dtype(entry.dtype), device=device)
        src = entry_tensor(entry, raw)
        if stream is None:
            dst.copy_(src)
            return
        if first[0] and after is not None:
            stream.wait_event(after)
        first[0] = False
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
        stream.synchronize()

    return install, staging


def unpack_params(buffer: np.ndarray, layout: ParamLayout) -> dict[str, torch.Tensor]:
    """Zero-copy host views into the buffer, name -> tensor."""
    return {e.name: entry_tensor(e, buffer[e.offset:e.offset + e.nbytes])
            for e in layout.entries}


def unflatten_like(template: Any, named: dict[str, Any]) -> Any:
    """Rebuild ``template``'s nesting from named leaves."""
    if isinstance(template, dict):
        return unflatten_names({n: named[n] for n, _ in
                                flatten_with_names(template)})
    return named[""]


# --------------------------------------------------------------------------
# Sharded weight fabric: trainer→engine resharding map
# --------------------------------------------------------------------------

# An entry sharded along a non-leading axis fragments into one byte range
# per outer block (prod(shape[:axis]) of them). Past this many ranges the
# per-stream manifests stop paying for shard affinity — the entry falls
# back to the replicated round-robin pool (coarse ALIGN-granular chunks),
# which changes stream/shard affinity but never coverage or correctness.
MAX_RANGES_PER_ENTRY = 256

# owner id for bytes no single (trainer, engine) shard pair owns:
# replicated entries, range-explosion fallbacks and alignment padding
POOL = -1


@dataclass(frozen=True)
class ShardSpec:
    """How one side of the fabric shards the flat layout's entries.

    ``num_shards`` is the shard count of the mesh axis (engine ``tp``,
    trainer ``fsdp``); ``axes`` maps entry name -> the tensor axis sharded
    over it (absent/None = replicated on that side). Wire-format friendly:
    receivers advertise it in their register message so the sender can
    build a :class:`ReshardingMap` per registration.
    """

    num_shards: int
    axes: dict[str, int | None]

    def axis_of(self, name: str) -> int | None:
        if self.num_shards <= 1:
            return None
        return self.axes.get(name)

    def to_jsonable(self) -> dict:
        return {"num_shards": int(self.num_shards),
                "axes": {k: v for k, v in self.axes.items()
                         if v is not None}}

    @staticmethod
    def from_jsonable(d: dict | None) -> "ShardSpec | None":
        if not d:
            return None
        return ShardSpec(int(d.get("num_shards", 1)),
                         {k: int(v) for k, v in d.get("axes", {}).items()})


def build_shard_spec(params: Any) -> ShardSpec:
    """The spec of an unsharded tree: one shard, every entry replicated
    (the port's trainer and engines each hold whole tensors on one
    device)."""
    return ShardSpec(1, {name: None for name, _ in flatten_with_names(params)})


def _shard_ranges(e: Entry, axis: int | None, n: int):
    """Absolute (offset, length) byte ranges each of ``n`` shards owns of
    entry ``e`` when sharded along tensor ``axis`` (row-major flat layout).
    Returns None when the split doesn't apply cleanly (replicated, n==1,
    non-divisible dim, or range explosion past MAX_RANGES_PER_ENTRY) —
    callers then route the entry to the pool."""
    if axis is None or n <= 1:
        return None
    if axis >= len(e.shape) or e.shape[axis] % n != 0:
        return None
    outer = int(np.prod(e.shape[:axis], dtype=np.int64)) if axis else 1
    if outer > MAX_RANGES_PER_ENTRY:
        return None
    item = _itemsize(e.dtype)
    inner = (int(np.prod(e.shape[axis + 1:], dtype=np.int64))
             if axis + 1 < len(e.shape) else 1) * item
    d = e.shape[axis]
    per = (d // n) * inner
    out = []
    for j in range(n):
        rs = []
        for o in range(outer):
            off = e.offset + o * d * inner + j * per
            if rs and rs[-1][0] + rs[-1][1] == off:
                rs[-1] = (rs[-1][0], rs[-1][1] + per)
            else:
                rs.append((off, per))
        out.append(rs)
    return out


def _intersect(a: list[tuple[int, int]], b: list[tuple[int, int]]):
    """Intersection of two sorted disjoint (offset, length) range lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][0] + a[i][1], b[j][0] + b[j][1])
        if lo < hi:
            out.append((lo, hi - lo))
        if a[i][0] + a[i][1] <= b[j][0] + b[j][1]:
            i += 1
        else:
            j += 1
    return out


@dataclass(frozen=True)
class ReshardingMap:
    """Per-byte ownership of the flat layout across (trainer shard →
    engine shard) pairs: ``atoms`` is a disjoint, offset-sorted cover of
    ``[0, total_bytes)`` as (offset, length, trainer_shard, engine_shard)
    with :data:`POOL` (-1) marking replicated/padding bytes. Built by
    :func:`build_resharding_map`; consumed by :meth:`stream_assignments`
    to fan a push round over N concurrent streams."""

    total_bytes: int
    num_trainer_shards: int
    num_engine_shards: int
    atoms: tuple[tuple[int, int, int, int], ...]

    def reshard_bytes(self) -> int:
        """Bytes with a real (non-pool) shard-pair owner."""
        return sum(ln for _, ln, t, e in self.atoms
                   if t != POOL or e != POOL)

    def stream_assignments(self, num_streams: int):
        """Pack the atoms into ``num_streams`` offset-sorted, coalesced
        (offset, length) lists: disjoint union covering [0, total_bytes),
        each stream carrying at most ceil(total/num_streams) + ALIGN
        bytes. Atoms are laid out pair-grouped (all of (t0,e0) first, ...)
        with the pool round-robined by the greedy fill, so a stream
        usually carries whole shard-pairs; atoms split only at ALIGN
        boundaries to keep resume ranges cheap to verify."""
        n = max(1, int(num_streams))
        if self.total_bytes == 0:
            return [[] for _ in range(n)]
        target = -(-self.total_bytes // n)
        ordered = sorted(
            self.atoms,
            key=lambda a: ((1, 0, 0) if a[2] == POOL and a[3] == POOL
                           else (0, a[2], a[3]), a[0]))
        streams: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        fill = [0] * n
        s = 0
        for off, ln, _t, _e in ordered:
            while ln > 0:
                if fill[s] >= target and s < n - 1:
                    s += 1
                room = target - fill[s]
                if room >= ln or s == n - 1:
                    take = ln
                else:
                    # split at an ALIGN boundary, rounding UP so the
                    # stream overshoots target by < ALIGN instead of
                    # leaving an un-splittable sliver
                    take = min(ln, -(-room // ALIGN) * ALIGN)
                streams[s].append((off, take))
                fill[s] += take
                off += take
                ln -= take
        for rs in streams:
            rs.sort()
            i = 1
            while i < len(rs):
                if rs[i - 1][0] + rs[i - 1][1] == rs[i][0]:
                    rs[i - 1] = (rs[i - 1][0], rs[i - 1][1] + rs[i][1])
                    del rs[i]
                else:
                    i += 1
        return streams


def build_resharding_map(layout: ParamLayout,
                         trainer_spec: ShardSpec | None,
                         engine_spec: ShardSpec | None) -> ReshardingMap:
    """Compute byte ownership of ``layout`` from the trainer's shard spec
    and the engine's: for each entry, the intersection of trainer shard
    i's ranges with engine shard j's. Replicated-on-both-sides entries,
    non-divisible splits, range explosions and alignment padding all land
    in the POOL. The atom set always covers [0, total_bytes) exactly —
    the receiver's gap verifier demands full coverage."""
    t_n = trainer_spec.num_shards if trainer_spec else 1
    e_n = engine_spec.num_shards if engine_spec else 1
    atoms: list[tuple[int, int, int, int]] = []
    for k, e in enumerate(layout.entries):
        t_ranges = _shard_ranges(
            e, trainer_spec.axis_of(e.name) if trainer_spec else None, t_n)
        e_ranges = _shard_ranges(
            e, engine_spec.axis_of(e.name) if engine_spec else None, e_n)
        if t_ranges is None and e_ranges is None:
            atoms.append((e.offset, e.nbytes, POOL, POOL))
        elif t_ranges is None:
            for j, rs in enumerate(e_ranges):
                atoms.extend((o, ln, POOL, j) for o, ln in rs)
        elif e_ranges is None:
            for i, rs in enumerate(t_ranges):
                atoms.extend((o, ln, i, POOL) for o, ln in rs)
        else:
            for i, trs in enumerate(t_ranges):
                for j, ers in enumerate(e_ranges):
                    atoms.extend((o, ln, i, j)
                                 for o, ln in _intersect(trs, ers))
        # alignment padding up to the next entry (or total_bytes)
        end = e.offset + e.nbytes
        nxt = (layout.entries[k + 1].offset if k + 1 < len(layout.entries)
               else layout.total_bytes)
        if nxt > end:
            atoms.append((end, nxt - end, POOL, POOL))
    atoms.sort()
    return ReshardingMap(layout.total_bytes, t_n, e_n, tuple(atoms))
