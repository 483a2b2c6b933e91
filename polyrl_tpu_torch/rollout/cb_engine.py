"""Continuous-batching rollout engine over a paged KV pool, in PyTorch.

Counterpart of the core of ``polyrl_tpu/rollout/cb_engine.py``:

- A fixed array of ``max_slots`` decode slots; per-slot sampling params,
  budgets and stop tokens are tensors, so any request mix shares one
  decode path.
- Paged KV: slots own page lists from a shared pool
  (``decoder.make_paged_pools``). Decode attention and the per-token KV
  write are the hand-written CUDA kernels of ``ops/paged_attention.py``.
  Dispatches with live GRPO groups (>= 2 active members sharing a prompt
  chain) route through the grouped shared-prefix kernel.
- Admission: waves of fresh prompts prefill in one batched forward; GRPO
  siblings of a published prompt batch-attach to its cached pages
  (group-shared prefill, ``prefix_cache.py``). The prefill writes the
  admitted slots' rows into the device state and queues its first tokens
  like any dispatch output (fused async admission).
- Device-resident state: the step's carry and inputs (page table, lengths,
  last tokens, counts, budgets, active flags, sampling params, stop
  table) live in tensors allocated once and updated in place, by the
  decode dispatch and by admission. The host numpy mirrors stay the truth
  for admission and catch up at emission; they are uploaded again only
  after a host event (an abort, a recovery, a stop the device missed),
  and only after a full drain.
- Decode: each dispatch runs ``steps_per_dispatch`` fused steps (the JAX
  ``lax.scan``) with the same active / done / budget / stop logic. On a
  CUDA device the dispatch is one captured CUDA graph per
  ``(use_filters, k, group shape)`` key (the JAX step's jit key), replayed
  on the card; the first dispatch of a key runs eagerly on a side stream
  (the warm-up) and is then captured. On the CPU the eager body runs.
- Run-ahead: up to ``pipeline_depth`` dispatches (default 16) run ahead of
  emission. Each dispatch's ``[k, S]`` outputs are copied without blocking
  into a pinned host ring and an event is recorded; a fetcher thread waits
  on the events and hands the arrays back to the loop thread, which emits
  them. Every output carries the weight version of its dispatch.
  ``pipeline_depth=0`` drains every dispatch: the synchronous engine.
- Salvage (``salvage_partials``, the default): an aborted slot stays active
  through a full drain, so every token its dispatches in flight decoded
  reaches the client before the ``abort`` terminal, and its full pages
  (prompt + generated) are published to the prefix cache for a
  continuation; ``stop()`` drains the same way. ``salvage_partials=False``
  drops what is in flight (the fast abort).
- Chunked prefill (``prefill_chunk``): a prompt longer than the chunk fills
  its KV one chunk per loop iteration, between decode dispatches; its last
  chunk goes through the normal suffix admission.
- Prompt-lookup speculation (``spec_tokens``): every decode dispatch runs
  ``spec_rounds`` rounds of n-gram proposal from a device token buffer,
  one verify forward over ``S * (spec_tokens + 1)`` virtual rows (the
  fused prologue and K2) and rejection sampling; on the card it is one
  more CUDA-graph key.
- Lifecycle: ``warmup`` (every prefill variant once, the ungrouped and
  spec decode graphs captured up front; a grouped key at its first
  dispatch), ``release_memory``/``resume_memory`` (the KV pools
  and the captured graphs freed for a colocated trainer, and rebuilt).
- The memory plane and the loop's instruments, on by default as in the
  JAX engine, each with its off switch: the page ledger
  (``rollout/kvledger.py``, ``kv_ledger``) fed at every page transition;
  the host spill tier (``rollout/kvspill.py``, ``kv_spill``, needs the
  ledger and the prefix cache): under watermark pressure cold unreferenced
  published pages are gathered on the compute stream and copied to pinned
  host buffers on a copy stream, their physical pages freed, and a prefix
  hit on them restores them in place into fresh pages of the live pools
  before the attach; the flight deck (``rollout/flightdeck.py``: request
  lifecycle, occupancy, token reconciliation); the loop profiler
  (``obs/engine_profile.py``, ``loop_profile``). None of them touches the
  sampling generator, or the device unless a spill or restore fires: with
  the ledger or the profiler off the outputs are bitwise the same; with
  the spill tier off only pressure acts otherwise (an eviction, then a
  full prefill, where a spill and a restore would keep the KV).

Where the JAX engine donates pools and state, this one updates the pools
and the device state in place. Not ported yet (see ROADMAP.md): a graph
for prefill, and TP meshes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from polyrl_tpu_torch.device import resolve_device
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.quant import named_leaves
from polyrl_tpu_torch.obs.engine_profile import EngineLoopProfiler
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops.paged_attention import grouped_paged_attention
from polyrl_tpu_torch.rollout.common import (
    check_same_structure,
    next_bucket,
    params_copy,
)
from polyrl_tpu_torch.rollout.flightdeck import EngineFlightDeck, ThroughputEWMA
from polyrl_tpu_torch.rollout.kvledger import PageLedger
from polyrl_tpu_torch.rollout.kvspill import HostSpillPool
from polyrl_tpu_torch.rollout.prefix_cache import PrefixCache
from polyrl_tpu_torch.rollout.sampling import (
    SamplingParams,
    sample_token_vec,
    spec_verify_sample_vec,
)

log = logging.getLogger(__name__)

STREAM_END = object()  # terminal marker on every request's output queue

MAX_STOP_TOKENS = 8

# columns of a packed device-state row (``_state_rows``): _NI ints, then
# the page-table row and the stop-table row; floats are (temperature, top_p)
_SEQ, _LAST, _NGEN, _BUDGET, _ACTIVE, _TOPK = range(6)
_NI = 6

# the phase context _phase() hands out when the loop profiler is off
# (nullcontext is reentrant): the hot path pays no allocation
_NULL_PHASE = contextlib.nullcontext()


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def device_ngram_propose(tok_buf: torch.Tensor, hist_len: torch.Tensor,
                         n_draft: int) -> torch.Tensor:
    """Prompt-lookup proposal on the device: for each slot, the latest
    earlier occurrence of the history's final trigram in ``tok_buf[s,
    :hist_len[s]]`` (else of its final bigram, else the last token
    repeated), and the ``n_draft`` tokens that followed it. Continuation
    positions past the history fall back to the last token. Fixed shapes,
    no host reads (capture-safe).

    tok_buf: [S, L] int32 (prompt + generated, front-filled)
    hist_len: [S] valid-prefix lengths
    returns: [S, n_draft] int32"""
    s, length = tok_buf.shape
    dev = tok_buf.device
    rows = torch.arange(s, device=dev)
    hl = hist_len.long()
    t_last = tok_buf[rows, (hl - 1).clamp(0, length - 1)]
    t_prev = tok_buf[rows, (hl - 2).clamp(0, length - 1)]
    t_prev2 = tok_buf[rows, (hl - 3).clamp(0, length - 1)]
    # bigram match at p: buf[p:p+2] == (t_prev, t_last), strictly before
    # the final bigram (p + 1 < hist_len - 1)
    idx2 = torch.arange(length - 1, device=dev)
    m2 = ((tok_buf[:, :-1] == t_prev[:, None])
          & (tok_buf[:, 1:] == t_last[:, None])
          & (idx2[None] + 1 < (hl - 1)[:, None]))
    p2 = torch.where(m2, idx2[None], -1).max(dim=1).values
    found2 = (p2 >= 0) & (hl >= 3)
    # trigram match at p, strictly before the final trigram
    idx3 = torch.arange(length - 2, device=dev)
    m3 = ((tok_buf[:, :-2] == t_prev2[:, None])
          & (tok_buf[:, 1:-1] == t_prev[:, None])
          & (tok_buf[:, 2:] == t_last[:, None])
          & (idx3[None] + 2 < (hl - 1)[:, None]))
    p3 = torch.where(m3, idx3[None], -1).max(dim=1).values
    found3 = (p3 >= 0) & (hl >= 4)
    start = torch.where(found3, p3 + 3, p2 + 2)
    found = found3 | found2
    gather = (start[:, None] + torch.arange(n_draft, device=dev)[None]
              ).clamp(0, length - 1)
    cont = tok_buf.gather(1, gather)
    cont = torch.where(gather < hl[:, None], cont, t_last[:, None])
    return torch.where(found[:, None], cont,
                       t_last[:, None].expand(s, n_draft)).to(torch.int32)


@dataclasses.dataclass
class _Request:
    rid: str
    input_ids: list[int]
    sampling: SamplingParams
    out: queue.Queue
    abort: Any  # threading.Event-like or None
    t_submit: float = 0.0
    # group-shared prefill hint (GRPO: the completions of one prompt share
    # group_id; group_size is the expected member count). A missing or
    # wrong hint degrades to per-request admission, never corrupts.
    group_id: str = ""
    group_size: int = 0


@dataclasses.dataclass
class _SlotInfo:
    req: _Request
    pages: list[int]            # slot-PRIVATE pages (freed on finalize)
    stop_set: set
    cache_entries: list = dataclasses.field(default_factory=list)
    emitted: list = dataclasses.field(default_factory=list)
    admit_version: int = 0


class PageAllocator:
    """Free-list allocator over pages 1..n-1 (page 0 = reserved null page)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        out = self._free[-n:]
        del self._free[-n:]
        return out

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)


class CBEngine:
    """Continuous-batching engine; the serving backend of RolloutServer."""

    ADMIT_WAVE = 8  # max admissions fused into one batched prefill
    GROUP_PREREF_TTL_S = 30.0

    def __init__(
        self,
        cfg: decoder.ModelConfig,
        params: dict,
        max_slots: int = 64,
        page_size: int = 64,
        num_pages: int | None = None,
        max_seq_len: int = 8192,
        prompt_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096),
        kv_cache_dtype: torch.dtype | None = None,
        pad_token_id: int = 0,
        seed: int = 0,
        enable_prefix_cache: bool = True,
        steps_per_dispatch: int = 8,
        pipeline_depth: int = 16,
        admit_wave: int | None = None,
        admit_reorder_window: int = 8,
        group_share: bool = True,
        decode_group_share: bool = True,
        group_preref_ttl_s: float | None = None,
        prefill_chunk: int = 0,
        spec_tokens: int = 0,
        spec_rounds: int = 2,
        salvage_partials: bool = True,
        kv_ledger: bool = True,
        kv_cold_after_dispatches: int = 256,
        kv_spill: bool = True,
        kv_spill_host_gb: float = 4.0,
        kv_spill_high_watermark: float = 0.92,
        kv_spill_low_watermark: float = 0.80,
        loop_profile: bool = True,
        device: str | torch.device = "cuda",
    ):
        if any(b % page_size for b in prompt_buckets):
            raise ValueError("prompt buckets must be page-aligned")
        if prefill_chunk < 0 or prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk must be a non-negative multiple of "
                f"page_size={page_size}, got {prefill_chunk}")
        if prefill_chunk and prefill_chunk > max(prompt_buckets):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds the largest prompt "
                f"bucket {max(prompt_buckets)}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if spec_rounds < 1:
            raise ValueError(f"spec_rounds must be >= 1, got {spec_rounds}")
        if not 0.0 < kv_spill_low_watermark <= kv_spill_high_watermark <= 1.0:
            raise ValueError(
                f"kv spill watermarks must satisfy 0 < low <= high <= 1, "
                f"got low={kv_spill_low_watermark} "
                f"high={kv_spill_high_watermark}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the engine's own copy, even of tensors already on its device: a
        # colocated actor updates its parameters in place, and an alias
        # would change the engine's weights with no version bump while the
        # prefix cache still held KV of the old ones
        self.params = params_copy(params, self.device)
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.pages_per_slot = -(-max_seq_len // page_size)
        # default pool: enough for half the slots at full length + slack
        self.num_pages = num_pages or (max_slots * self.pages_per_slot // 2 + 1)
        self.prompt_buckets = tuple(prompt_buckets)
        self.kv_cache_dtype = kv_cache_dtype or cfg.dtype
        self.pad_token_id = pad_token_id

        s, p = max_slots, self.pages_per_slot
        self._page_table = np.zeros((s, p), np.int32)
        self._seq_lens = np.zeros((s,), np.int32)
        self._last_tokens = np.full((s,), pad_token_id, np.int32)
        self._n_generated = np.zeros((s,), np.int32)
        self._budgets = np.zeros((s,), np.int32)
        self._active = np.zeros((s,), bool)
        self._temps = np.ones((s,), np.float32)
        self._top_ps = np.ones((s,), np.float32)
        self._top_ks = np.zeros((s,), np.int32)
        self._stop_table = np.full((s, MAX_STOP_TOKENS), -1, np.int32)
        self._slots: list[_SlotInfo | None] = [None] * s
        # per-slot admission generation: an emission recorded against an
        # older generation of a reused slot is dropped
        self._slot_gen = np.zeros((s,), np.int64)
        # per-slot tokens covered by dispatches in flight (the tail cutoff:
        # a dispatch past every active slot's budget computes pad rows only)
        self._inflight_tok = np.zeros((s,), np.int64)

        self.allocator = PageAllocator(self.num_pages)
        # the page ledger: role, owner, age and free cause of every page,
        # fed at each page transition below (None: no accounting)
        self.kvledger = (PageLedger(
            self.num_pages, page_size,
            cold_after_dispatches=kv_cold_after_dispatches,
            device=self.device) if kv_ledger else None)
        self._weight_bytes: int | None = None
        # the cache frees through _free_cache_pages, so the ledger sees the
        # cause the cache booked
        self.prefix_cache = (PrefixCache(page_size, self._free_cache_pages)
                             if enable_prefix_cache else None)
        # the host spill tier needs the ledger (candidates by idle age, the
        # accounting) and the prefix cache (the spillable pages)
        self.kvspill = (HostSpillPool(
            int(float(kv_spill_host_gb) * 1e9), self.device)
            if (kv_spill and kv_ledger and enable_prefix_cache) else None)
        self.kv_spill_high_watermark = float(kv_spill_high_watermark)
        self.kv_spill_low_watermark = float(kv_spill_low_watermark)
        if self.prefix_cache is not None and self.kvledger is not None:
            # cold-first capacity eviction, spill or not
            self.prefix_cache.idle_age = self.kvledger.idle_age
        if self.kvspill is not None:
            self.prefix_cache.drop_spilled = self._drop_spilled_entries
        self._pools = decoder.make_paged_pools(
            cfg, self.num_pages, page_size, dtype=self.kv_cache_dtype,
            device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        # device-resident control state, allocated once (a captured graph
        # reads and advances these very tensors); stale until uploaded
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self._dev = {
            "page_table": torch.zeros((s, p), **i32),
            "seq_lens": torch.zeros((s,), **i32),
            "last_tokens": torch.zeros((s,), **i32),
            "n_generated": torch.zeros((s,), **i32),
            "budgets": torch.zeros((s,), **i32),
            "active": torch.zeros((s,), dtype=torch.bool, device=dev),
            "temps": torch.ones((s,), dtype=torch.float32, device=dev),
            "top_ps": torch.ones((s,), dtype=torch.float32, device=dev),
            "top_ks": torch.zeros((s,), **i32),
            "stop_table": torch.full((s, MAX_STOP_TOKENS), -1, **i32),
        }
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # prompt-lookup speculation: with spec_tokens > 0 every decode
        # dispatch is spec_rounds rounds of propose / verify / accept, and
        # the device state carries each slot's token history (prompt +
        # emitted, front-filled), mirrored on the host in _hist
        self.spec_tokens = int(spec_tokens)
        self.spec_rounds = int(spec_rounds)
        self._hist: list[list[int] | None] | None = (
            [None] * s if self.spec_tokens > 0 else None)
        if self._hist is not None:
            self._dev["tok_buf"] = torch.zeros((s, max_seq_len), **i32)
        self.spec_emitted = 0        # tokens emitted by spec dispatches
        self.spec_dispatches = 0
        self.spec_token_ceiling = 0  # what those dispatches could emit
        self._dev_stale = True
        # the decode dispatch's outputs, [rows, S]: static, overwritten by
        # the next dispatch (the D2H copy is queued right behind each one);
        # rows = k, or spec_rounds * (spec_tokens + 1) plus an ``emitted``
        # mask (a rejected draft's row is no emission)
        spec = self.spec_tokens > 0
        rows = (self.spec_rounds * (self.spec_tokens + 1) if spec
                else self.steps_per_dispatch)
        self._out = (torch.zeros((rows, s), **i32),
                     torch.zeros((rows, s), dtype=torch.float32, device=dev),
                     torch.zeros((rows, s), dtype=torch.bool, device=dev)) + (
            (torch.zeros((rows, s), dtype=torch.bool, device=dev),)
            if spec else ())
        # group-table buffers per group shape (ng, gmax, p_pre)
        self._gbufs: dict[tuple, torch.Tensor] = {}
        # CUDA graphs: key -> (graph, the launches its capture recorded)
        self._use_graphs = dev.type == "cuda"
        self._graphs: dict[tuple, tuple] = {}
        self._graph_pool = None
        self._side_stream = torch.cuda.Stream(dev) if self._use_graphs else None
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        self.graph_replays = 0
        self.decode_host_s = 0.0

        # run-ahead: how many dispatch outputs may await emission. Cost: up
        # to this many dispatches of abort/admission latency. 0 = drain
        # every dispatch (synchronous).
        self.pipeline_depth = max(0, int(pipeline_depth))
        # emission queue: _emit_q (dispatched, not fetched), the fetcher's
        # in-flight count, _fetched_q (landed, not emitted), the fetch
        # exception and epoch (bumped by _recover/stop: stale results are
        # dropped) -- all guarded by _fetch_cv; emission stays on the loop
        # thread
        self._fetch_cv = threading.Condition()
        self._emit_q: collections.deque = collections.deque()
        self._fetched_q: collections.deque = collections.deque()
        self._fetch_inflight = 0
        self._fetch_exc: BaseException | None = None
        self._fetch_epoch = 0
        self._fetch_thread: threading.Thread | None = None
        # pinned host ring for the decode outputs; a slot is reused only
        # once its entry has been emitted or dropped
        pin = self._use_graphs
        self._ring = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                            for t in self._out)
                      for _ in range(self.pipeline_depth + 1)]
        self._ring_free = collections.deque(range(len(self._ring)))

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._paused = threading.Event()  # release_memory until resume
        self._idle = threading.Event()
        self._idle.set()
        # serializes dispatches against in-place weight updates
        self._pool_lock = threading.Lock()
        self._loop_thread: threading.Thread | None = None
        self._start_lock = threading.Lock()

        self.admit_wave = max(1, int(admit_wave if admit_wave is not None
                                     else self.ADMIT_WAVE))
        self.admit_reorder_window = max(0, int(admit_reorder_window))
        self.group_share = bool(group_share)
        self.prefill_dispatches = 0
        self.sibling_attach_dispatches = 0
        self.group_forked_requests = 0
        self._group_prerefs: dict[str, dict] = {}
        self.group_preref_ttl_s = float(
            group_preref_ttl_s if group_preref_ttl_s is not None
            else self.GROUP_PREREF_TTL_S)
        # shared-prefix decode groups: group_id -> {"n_pre", "pages",
        # "slots"}; loop thread only
        self.decode_group_share = bool(decode_group_share)
        self._decode_groups: dict[str, dict] = {}
        self._slot_decode_gid: dict[int, str] = {}
        self.grouped_decode_dispatches = 0
        self.decode_dispatches = 0
        # recent admissions: (rid, wave kind, wave size, prompt bucket)
        self.admissions: collections.deque = collections.deque(maxlen=4096)
        # chunked prefill: prompts longer than this fill one chunk per loop
        # iteration, between decode dispatches (0 = off)
        self.prefill_chunk = int(prefill_chunk)
        self._chunk_jobs: collections.deque = collections.deque()
        self.chunk_dispatches = 0
        # salvage: aborts and stop() drain what is in flight into the
        # streams first and publish the aborted slots' full pages
        self.salvage_partials = bool(salvage_partials)
        self.tokens_salvaged = 0
        self.salvage_published_pages = 0

        self.weight_version = 0
        self.num_running = 0
        self.num_queued = 0
        self.last_gen_throughput = 0.0
        self.total_tokens_served = 0
        self._tok_window: collections.deque = collections.deque(maxlen=64)
        self._tput_ewma = ThroughputEWMA()
        # the flight deck: request lifecycle (queue wait, TTFT, TPOT, token
        # counts) and scheduler occupancy, with the request-vs-scheduler
        # token reconciliation
        self.deck = EngineFlightDeck(max_slots, self.num_pages, page_size)
        # the loop profiler: each loop iteration's wall split over the
        # phase taxonomy (None: no clocks around the loop)
        self.profiler = EngineLoopProfiler() if loop_profile else None

    # -- the loop profiler (obs/engine_profile.py) ----------------------------

    def _phase(self, name: str):
        """The profiler's phase context for ``name`` (a no-op when off)."""
        prof = self.profiler
        return prof.phase(name) if prof is not None else _NULL_PHASE

    def loop_profile_info(self) -> dict:
        """Flat server_info fields of the loop profiler ({} when off)."""
        if self.profiler is None:
            return {}
        return self.profiler.server_info_fields()

    def loop_profile_snapshot(self) -> dict:
        """The nested ``engine.loop`` view (``{"enabled": False}`` when
        off)."""
        if self.profiler is None:
            return {"enabled": False}
        return self.profiler.snapshot()

    # -- the KV memory plane (rollout/kvledger.py) ----------------------------

    # cache-side free causes -> ledger taxonomy
    _CACHE_CAUSE = {"capacity": "cache_pressure", "flush": "flush",
                    "preref_ttl": "preref_ttl"}

    def _free_cache_pages(self, pages: list[int]) -> None:
        """The prefix cache's free callback: the pages go back to the
        allocator, and the ledger books them under the cause the cache
        recorded just before calling."""
        self.allocator.free(pages)
        if self.kvledger is not None:
            cause = self.prefix_cache.last_free_cause
            self.kvledger.on_free(
                pages, self._CACHE_CAUSE.get(cause, "cache_pressure"))

    def _free_slot_pages(self, pages: list[int], cause: str) -> None:
        self.allocator.free(pages)
        if self.kvledger is not None:
            self.kvledger.on_free(pages, cause)

    def _accounted_bytes(self) -> float:
        """Device bytes the ledger can attribute: the KV pools and the
        weights (their total is fixed: weight updates copy in place). Sets
        the ledger's bytes per page from the pools."""
        if self._weight_bytes is None:
            self._weight_bytes = sum(t.numel() * t.element_size()
                                     for _, t in named_leaves(self.params))
        pools = self._pools
        pool_b = (sum(t.numel() * t.element_size() for t in pools[0] + pools[1])
                  if pools is not None else 0)
        if self.kvledger is not None and pool_b:
            self.kvledger.page_bytes = pool_b // self.num_pages
        return float(self._weight_bytes + pool_b)

    def _cache_pages(self) -> int:
        return (self.prefix_cache.num_entries
                if self.prefix_cache is not None else 0)

    def kv_memory_info(self) -> dict:
        """Flat server_info fields of the memory plane ({} when the ledger
        is off). Safe from handler threads: the ledger locks."""
        if self.kvledger is None:
            return {}
        return self.kvledger.server_info_fields(
            self.allocator.free_count, self._cache_pages(),
            self._accounted_bytes())

    def kv_memory_snapshot(self) -> dict:
        """The nested ``memory`` view ({} when the ledger is off); the host
        pool's own truth joins as ``spill.host``."""
        if self.kvledger is None:
            return {}
        snap = self.kvledger.snapshot(
            self.allocator.free_count, self._cache_pages(),
            self._accounted_bytes())
        if self.kvspill is not None:
            snap.setdefault("spill", {})["host"] = self.kvspill.stats()
        return snap

    # -- the host spill tier (rollout/kvspill.py) -----------------------------

    def _drop_spilled_entries(self, entries: list) -> None:
        """Spilled content died without a restore (cache flush, a stale
        squatter replaced, engine stop): the host copy goes and the ledger
        settles; the physical pages were freed at spill time."""
        handles = [e.spill_handle for e in entries if e.spilled]
        for e in entries:
            e.spilled = False
            e.spill_handle = -1
        if not handles:
            return
        self.kvspill.drop(handles)
        self.kvledger.on_spill_drop(len(handles))

    def _spill_sweep(self) -> None:
        """After each decode dispatch: page use at or over the high
        watermark spills cold unreferenced published pages down toward the
        low one. The gap between the two keeps demand restores from
        arming the sweep again page by page."""
        n = max(1, self.num_pages - 1)
        util = 1.0 - self.allocator.free_count / n
        if util < self.kv_spill_high_watermark:
            return
        target = int(np.ceil((util - self.kv_spill_low_watermark) * n))
        if target > 0:
            self._spill_pages(target, cold_only=True)

    def _spill_pages(self, target: int, cold_only: bool) -> int:
        """Page out up to ``target`` unreferenced published prefix-cache
        pages, coldest first (``cold_only``: only the ledger's cold tier,
        the sweep's mode; allocation pressure takes any unreferenced
        published page, since a spill keeps the KV that an eviction
        destroys). Returns how many pages were spilled.

        The gather runs on the compute stream behind every dispatch already
        queued, so the physical pages go back to the allocator at once: a
        later prefill that writes them is queued after the gather. With
        ``lane_depth`` batches in flight nothing is spilled, as in the JAX
        engine: the sweep tries again after a later dispatch, and allocation
        pressure evicts."""
        if (self.kvspill is None or self._pools is None or target <= 0
                or not self.kvspill.lane_free()):
            return 0
        with self._phase("spill_sweep"):
            return self._spill_pages_inner(target, cold_only)

    def _spill_pages_inner(self, target: int, cold_only: bool) -> int:
        age = self.kvledger.idle_age
        cands = [(age(e.page), e) for e in self.prefix_cache.spill_candidates()]
        if cold_only:
            cands = [c for c in cands if c[0] >= self.kvledger.cold_after]
        if not cands:
            return 0
        cands.sort(key=lambda c: (-c[0], c[1].tick))
        self._accounted_bytes()  # the ledger's bytes per page
        page_bytes = int(self.kvledger.page_bytes)
        take = min(target, len(cands))
        while take > 0 and not self.kvspill.can_spill(take, page_bytes):
            take -= 1  # host capacity: spill what fits, never evict here
        if take <= 0:
            return 0
        entries = [e for _age, e in cands[:take]]
        pages = [e.page for e in entries]
        kp, vp = self._pools
        idx = self._tensor(np.asarray(pages, np.int64))
        # page-major [n, 2L, Hkv, ps, D]: one contiguous block per page,
        # filled a layer at a time (the transient beside the block is one
        # layer's slice)
        kv = torch.empty((len(pages), 2 * len(kp)) + tuple(kp[0][:, 0].shape),
                         dtype=kp[0].dtype, device=self.device)
        for j, pool in enumerate(kp + vp):
            kv[:, j] = pool.index_select(1, idx).transpose(0, 1)
        handles = self.kvspill.spill(kv, page_bytes)
        for e, h in zip(entries, handles):
            e.spilled = True
            e.spill_handle = h
        self.allocator.free(pages)
        self.kvledger.on_spill(pages)
        return len(pages)

    def _restore_matched(self, matched_entries: list) -> tuple[list[int], list]:
        """A prefix match landed on spilled entries: restore them into
        fresh pages before the attach. If pages for the whole chain cannot
        be found, the chain is cut at its first entry still spilled (the
        cut tail's match refs are released): a shorter hit, never a wrong
        one. Returns the (possibly cut) pages and entries."""
        spilled = [e for e in matched_entries if e.spilled]
        if spilled and not self._restore_entries(spilled):
            cut = next(i for i, e in enumerate(matched_entries) if e.spilled)
            self.prefix_cache.release(matched_entries[cut:])
            matched_entries = matched_entries[:cut]
        return [e.page for e in matched_entries], matched_entries

    def _restore_entries(self, entries: list) -> bool:
        """Restore spilled entries into freshly allocated pages of the live
        pools, in place (the captured decode graphs replay from the pools'
        addresses): pinned host buffers to a device staging tensor, then
        one ``index_copy_`` per layer, all on the compute stream before the
        attach prefill that reads them. A restored chain sits at new
        physical pages, and decode-group seating keys on exact chains: a
        group whose members attached on both sides of a spill decodes
        apart (K2 for a lone member). Returns False (nothing restored) when
        no pages can be found even after spilling colder pages or
        evicting."""
        with self._phase("restore"):
            return self._restore_entries_inner(entries)

    def _restore_entries_inner(self, entries: list) -> bool:
        need = len(entries)
        pages = self.allocator.alloc(need)
        while pages is None and self._outstanding():
            self._drain_emit_q(keep=self._outstanding() - 1)
            pages = self.allocator.alloc(need)
        if pages is None:
            # colder spillable pages make room without losing KV; the
            # entries being restored are spilled already, so they are no
            # candidates
            if self._spill_pages(need - self.allocator.free_count,
                                 cold_only=False):
                pages = self.allocator.alloc(need)
        if pages is None and self.prefix_cache.evict(
                need - self.allocator.free_count):
            pages = self.allocator.alloc(need)
        if pages is None:
            return False
        kp, vp = self._pools
        handles = [e.spill_handle for e in entries]
        staging = torch.empty((need, 2 * len(kp)) + tuple(kp[0][:, 0].shape),
                              dtype=kp[0].dtype, device=self.device)
        self.kvspill.load(handles, staging)
        idx = self._tensor(np.asarray(pages, np.int64))
        for j, pool in enumerate(kp + vp):
            pool.index_copy_(1, idx, staging[:, j].transpose(0, 1))
        self.kvspill.drop(handles, restored=True)
        for e, p in zip(entries, pages):
            e.page = int(p)
            e.spilled = False
            e.spill_handle = -1
        self.kvledger.on_restore(pages)
        return True

    # -- submission API (server-facing) -------------------------------------

    def submit(self, rid: str, input_ids: list[int], sampling: SamplingParams,
               out: queue.Queue | None = None, abort=None,
               group_id: str = "", group_size: int = 0) -> queue.Queue:
        out = out if out is not None else queue.Queue()
        self._queue.put(_Request(rid, list(input_ids), sampling, out, abort,
                                 time.monotonic(), group_id=str(group_id),
                                 group_size=int(group_size)))
        self.num_queued = self._queue.qsize() + len(self._pending)
        return out

    def start(self) -> "CBEngine":
        # a pipelined trainer's producer and its validation may both call
        # generate (and so start) from two threads
        with self._start_lock:
            if self._loop_thread is None:
                self._stop.clear()
                self._fetch_thread = threading.Thread(
                    target=self._fetch_loop, name="cb-engine-fetch",
                    daemon=True)
                self._fetch_thread.start()
                self._loop_thread = threading.Thread(
                    target=self._loop, name="cb-engine-loop", daemon=True)
                self._loop_thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the loop and fetcher threads; every in-flight and
        queued request gets a terminal line and ``STREAM_END``. With
        ``salvage_partials`` (the default) the dispatches in flight are
        drained into their streams first and the in-flight requests end in
        an ``abort`` partial; without it what is in flight is dropped and
        they end in an ``error``."""
        self._stop.set()
        for name in ("_loop_thread", "_fetch_thread"):
            t = getattr(self, name)
            if t is not None:
                with self._fetch_cv:
                    self._fetch_cv.notify_all()
                t.join(timeout=60.0)
                if t.is_alive():
                    raise RuntimeError(f"engine thread {t.name} did not stop")
                setattr(self, name, None)
        if self.salvage_partials and self._pools is not None:
            # both threads are joined: the drain lands every queued output
            # on this thread, and the decoded tokens stream out before the
            # terminal lines below. A failing drain must not wedge shutdown.
            try:
                with self._pool_lock:
                    self._drain_emit_q()
            except Exception:  # noqa: BLE001
                log.exception("shutdown salvage drain failed")
        self._drop_outputs()
        with self._pool_lock:
            self._fail_all("engine shutdown",
                           finish_reason="abort" if self.salvage_partials
                           else "error")
            self._decode_groups.clear()
            self._slot_decode_gid.clear()
            while self._chunk_jobs:
                job = self._chunk_jobs.popleft()
                self._finalize(job["slot"], cause="abort")
                self._emit_error(job["req"], "engine shutdown")
            if self.prefix_cache is not None:
                # the flush drops every spilled entry (both tiers)
                self._disband_group_prerefs()
                self.prefix_cache.flush()
        self._drain_queue()
        while self._pending:
            self._emit_error(self._pending.popleft(), "engine shutdown")
        if self.kvspill is not None:
            self.kvspill.stop()

    # -- weights -------------------------------------------------------------

    def update_weights(self, params: dict, version: int | None = None) -> None:
        """Copy ``params`` into the engine's tensors in place and bump
        ``weight_version``. The tree must have the engine's leaf names,
        shapes and dtypes (any device): ``copy_`` would cast silently, and a
        bf16 tree pushed into an int8 engine must be re-quantized first
        (``quant.quantize_params``; the server's ``weight_preprocess``), as
        the reference refuses a tree of another structure. Runs between
        dispatches (under the dispatch lock) and flushes the prefix cache:
        cached KV belongs to the old weights. The copy is queued on the
        caller's stream, the default one, as are the decode replays: it
        runs after the dispatches already queued, whose tokens carry the
        old version, and before the later ones."""
        check_same_structure(params, self.params)
        new = dict(named_leaves(params))
        cur = dict(named_leaves(self.params))
        with self._pool_lock, torch.no_grad():
            for k, dst in cur.items():
                dst.copy_(new[k])
            self.weight_version = (self.weight_version + 1 if version is None
                                   else int(version))
            if self.prefix_cache is not None:
                self._disband_group_prerefs()
                self.prefix_cache.flush()

    def flush_prefix_cache(self) -> None:
        with self._pool_lock:
            if self.prefix_cache is not None:
                self._disband_group_prerefs()
                self.prefix_cache.flush()

    def reset_throughput_window(self) -> None:
        """Zero the rolling tok/s window, so that one phase's throughput
        does not leak into the next's."""
        self._tok_window.clear()
        self._tput_ewma.reset()
        self.last_gen_throughput = 0.0

    # -- warm-up -----------------------------------------------------------------

    def warmup(self, batch_sizes=(2, 4, 8), filter_variants=(False, True),
               suffix: bool = True) -> None:
        """Drive every admission variant once and capture the decode graphs
        before serving, so that neither lands in the first real dispatch:
        each prompt bucket's fresh prefill (alone and at each batch size),
        with ``suffix`` the prefix-hit variants (power-of-two prefix page
        counts; for the first bucket, the batched sibling attach up to the
        largest prompt), each sampled with every sampling-filter variant
        (the prefill is eager: one forward serves them all); then the
        ungrouped decode key of each filter variant (the spec key on a
        speculating engine), as the JAX engine precompiles its step. A
        grouped decode key depends on the live groups' shape (``(ng, gmax,
        p_pre)``, each a power of two up to the slot and page counts) and is
        captured at its first dispatch. Prefill rows write to the null page
        only and insert no slot (the JAX engine's sink row); the decode
        dispatches run on a blank state (every slot inactive, every page
        null), and the device state is put back afterwards, so live slots
        and the pools' pages are left as they were. The sampling generator
        advances."""
        ps = self.page_size
        with self._pool_lock:
            self._drain_emit_q()
            self._ensure_dev_state()
            for pb in self.prompt_buckets:
                for nb in (1,) + tuple(batch_sizes):
                    self._warm_prefill(pb, nb, filter_variants)
                n_pre = 1
                while suffix and n_pre <= max(1, pb // ps):
                    self._warm_prefill(pb, 1, filter_variants, n_pre)
                    n_pre *= 2
                if suffix and self.group_share and pb == self.prompt_buckets[0]:
                    n_pre = 1
                    while n_pre <= max(1, self.prompt_buckets[-1] // ps):
                        self._warm_prefill(pb, max(batch_sizes), filter_variants,
                                           n_pre)
                        n_pre *= 2
            saved = {name: t.clone() for name, t in self._dev.items()}
            try:
                for t in self._dev.values():
                    t.zero_()
                for name in ("temps", "top_ps"):
                    self._dev[name].fill_(1.0)
                self._dev["stop_table"].fill_(-1)
                for uf in filter_variants:
                    if self.spec_tokens > 0:
                        self._launch(self._spec_key(uf),
                                     lambda uf=uf: self._spec_body(uf))
                    else:
                        self._launch_decode(uf, None)
            finally:
                for name, t in saved.items():
                    self._dev[name].copy_(t)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _warm_prefill(self, pb: int, nb: int, filter_variants,
                      n_pre: int = 0) -> None:
        """One discarded prefill of ``nb`` rows of bucket ``pb`` (a suffix
        prefill over ``n_pre`` prefix pages when ``n_pre``) and its
        first-token sampling, once per filter variant; every page id is
        the null page."""
        ps = self.page_size
        ids = self._tensor(np.full((nb, pb), self.pad_token_id, np.int32))
        lens = self._tensor(np.ones((nb,), np.int32))
        page_ids = self._tensor(np.zeros((nb, pb // ps), np.int32))
        if n_pre:
            _, last = decoder.prefill_suffix_batch_into_pages(
                self.params, self.cfg, ids, lens, n_pre * ps, self._pools,
                self._tensor(np.zeros((nb, n_pre), np.int32)), page_ids)
        else:
            _, last = decoder.prefill_batch_into_pages(
                self.params, self.cfg, ids, lens, self._pools, page_ids)
        ones = torch.ones((nb,), dtype=torch.float32, device=self.device)
        zeros = torch.zeros((nb,), dtype=torch.int32, device=self.device)
        for uf in filter_variants:
            sample_token_vec(last, self._gen, ones, ones, zeros, use_filters=uf)

    # -- memory lifecycle (a colocated trainer takes the KV pool back) -------

    def release_memory(self) -> None:
        """Pause serving and, once the running requests are done, free the
        KV pools. The captured decode graphs hold the pools' addresses, so
        they go first, with their private memory pool; then the pools; then
        the allocator's cache is returned to the device. A request
        submitted meanwhile waits for ``resume_memory``; mid-chunk prefill
        jobs, whose filled KV goes with the pools, are aborted. The cache
        flush drops spilled entries from both tiers; no spill runs while
        the pools are gone."""
        self._paused.set()
        if not self._idle.wait(timeout=30.0):
            return
        with self._pool_lock:
            if self._active.any() or self._pools is None:
                return
            self._drain_emit_q()  # the run-ahead tail (pad rows only)
            self._abort_chunk_jobs()
            if self.prefix_cache is not None:
                self._disband_group_prerefs()
                self.prefix_cache.flush()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._graphs.clear()
            self._graph_pool = None
            self._pools = None
            self._dev_stale = True
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def resume_memory(self) -> None:
        """Allocate the KV pools again and resume serving; the decode graphs
        are captured again at their first dispatch (or by ``warmup``)."""
        with self._pool_lock:
            if self._pools is None:
                self._pools = decoder.make_paged_pools(
                    self.cfg, self.num_pages, self.page_size,
                    dtype=self.kv_cache_dtype, device=self.device)
        self._paused.clear()

    # -- engine loop ---------------------------------------------------------

    def _loop(self) -> None:
        prof = self.profiler
        while not self._stop.is_set():
            try:
                if prof is not None:
                    # one attribution window per iteration: the phases'
                    # self-times partition its wall, the rest is `other`
                    with prof.iteration():
                        self._loop_iter()
                else:
                    self._loop_iter()
            except Exception:  # noqa: BLE001 — a dead loop wedges every
                # connected HTTP handler; fail the running requests instead
                log.exception("engine iteration failed; failing active requests")
                self._recover()

    def _loop_iter(self) -> None:
        if self._paused.is_set():
            if self._outstanding():
                with self._pool_lock:
                    self._drain_emit_q()
            self._idle.set()
            with self._phase("idle"):
                time.sleep(0.02)
            return
        self._drain_queue()
        if (not self._pending and not self._active.any()
                and not self._chunk_jobs):
            if self._outstanding():  # the run-ahead tail: pad rows only
                with self._pool_lock:
                    self._drain_emit_q()
            self.deck.on_idle()
            self._idle.set()
            try:
                with self._phase("idle"):
                    req = self._queue.get(timeout=0.05)
                self._pending.append(req)
            except queue.Empty:
                pass
            return
        self._idle.clear()
        with self._pool_lock:
            if self._paused.is_set():  # raced with release_memory
                return
            self._admit()
            if self._chunk_jobs:
                # one chunk per iteration: a long prompt's admission
                # interleaves with the decode dispatch below
                with self._phase("prefill_dispatch"):
                    self._advance_chunk_job()
            if self._active.any():
                self._step_once()
            elif self._pending and not self._chunk_jobs:
                with self._phase("idle"):
                    time.sleep(0.005)  # pending but blocked on pages/slots

    def _abort_chunk_jobs(self) -> None:
        while self._chunk_jobs:
            job = self._chunk_jobs.popleft()
            self._finalize(job["slot"], cause="abort")
            self._emit_abort(job["req"])

    def _recover(self) -> None:
        """After a failed iteration: drop every queued output (the epoch
        bump orphans a fetch still under way), error every running request
        and release its pages. The pools are updated in place (nothing was
        donated), so they stay valid for the next admissions."""
        self._drop_outputs()
        with self._pool_lock:
            self._fail_all("engine error")
            self._decode_groups.clear()
            self._slot_decode_gid.clear()
            self._abort_chunk_jobs()
            if self.prefix_cache is not None:
                self._disband_group_prerefs()
                self.prefix_cache.flush()

    def _drop_outputs(self) -> None:
        """Bump the fetch epoch and drop every queued dispatch output: what
        a fetch still under way lands afterwards is dropped at emission.
        The device state is uploaded again before its next use."""
        with self._fetch_cv:
            self._fetch_epoch += 1
            for entry in self._emit_q:
                self._release(entry)
            for _ep, entry, _a in self._fetched_q:
                self._release(entry)
            self._emit_q.clear()
            self._fetched_q.clear()
            self._fetch_exc = None
        self._inflight_tok[:] = 0
        self._dev_stale = True

    def _drain_queue(self) -> None:
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        self.num_queued = len(self._pending)

    # -- admission -------------------------------------------------------------

    def _admit(self) -> None:
        with self._phase("accounting"):
            self._sweep_group_prerefs()
        while self._pending:
            with self._phase("collect_wave"):
                wave, kind = self._collect_wave()
            if not wave:
                break
            try:
                with self._phase("prefill_dispatch"):
                    if kind == "attach" and len(wave) > 1:
                        self._prefill_attach_wave(wave)
                    elif len(wave) == 1:
                        req, slot, pages, budget, mp, me = wave[0]
                        self._prefill_request(slot, req, pages, budget, mp,
                                              me)
                    else:
                        self._prefill_wave(wave)
                self.prefill_dispatches += 1
                self.deck.on_admit_wave(len(wave))
            except Exception:
                for req, slot, pages, _b, _mp, me in wave:
                    if self._slots[slot] is not None and self._slots[slot].req is req:
                        continue  # admitted before the failure: _recover owns it
                    self._free_slot_pages(pages, "abort")
                    if self.prefix_cache is not None:
                        self.prefix_cache.release(me)
                    self._emit_error(req, "prefill failed")
                raise
        self.num_queued = len(self._pending)

    def _collect_wave(self) -> tuple[list, str]:
        """Collect up to ``admit_wave`` admissible requests, reserving a slot
        and pages for each: (req, slot, pages, budget, matched_pages,
        matched_entries), plus the wave kind — ``"fresh"`` (no cached
        prefix: one batched full-prompt prefill) or ``"attach"`` (every
        member a FULL prefix hit with the same prefix page count, e.g. the
        GRPO siblings of a published prompt: one batched suffix prefill).

        A head that cannot join the forming wave is skipped, up to
        ``admit_reorder_window`` skips; page exhaustion ends the scan. A
        prompt whose uncached part is longer than ``prefill_chunk`` becomes
        a chunk job instead (its slot and pages reserved), and siblings of
        a prompt in a chunk job wait for its publish."""
        wave: list = []
        kind = "fresh"
        attach_len = -1
        assigned: set[int] = set()
        wave_page_keys: set = set()
        chunk_keys = {job["first_key"] for job in self._chunk_jobs}
        chunk_keys.discard(None)
        skipped = 0
        scan = 0
        while len(wave) < self.admit_wave and scan < len(self._pending):
            free = [int(i) for i in np.flatnonzero(
                        ~self._active & np.asarray(
                            [s is None for s in self._slots]))
                    if int(i) not in assigned]
            if not free:
                break
            req = self._pending[scan]
            if req.abort is not None and req.abort.is_set():
                del self._pending[scan]
                self._emit_abort(req)
                self._consume_group_preref(req)
                continue
            n_prompt = len(req.input_ids)
            if n_prompt == 0 or n_prompt > min(self.max_seq_len - 1,
                                               self.prompt_buckets[-1]):
                del self._pending[scan]
                self._emit_error(req, f"prompt length {n_prompt} unsupported")
                self._consume_group_preref(req)
                continue
            budget = min(req.sampling.max_new_tokens,
                         self.max_seq_len - n_prompt)
            n_pages = -(-(n_prompt + budget) // self.page_size)
            n_full = max(0, (n_prompt - 1) // self.page_size)
            matched_pages: list[int] = []
            matched_entries: list = []
            first_key = None
            if self.prefix_cache is not None:
                matched_pages, matched_entries = self.prefix_cache.match(
                    req.input_ids)
                if self.kvspill is not None and any(
                        e.spilled for e in matched_entries):
                    # a hit on spilled KV: restore, then attach
                    matched_pages, matched_entries = self._restore_matched(
                        matched_entries)
                if n_full > 0:
                    first_key = self.prefix_cache._keys_for(req.input_ids, 1)[0]
            full_hit = bool(matched_pages) and len(matched_pages) == n_full
            # sibling wait: the prompt's first full page is being computed
            # by a request already in this wave (siblings of an unpublished
            # leader) or by a chunk job -- admitting it now would recompute
            # the shared prefix
            blocked = (not matched_pages and first_key is not None
                       and (first_key in wave_page_keys
                            or first_key in chunk_keys))
            prefix_cached = len(matched_pages) * self.page_size
            chunked = bool(self.prefill_chunk
                           and n_prompt - prefix_cached > self.prefill_chunk)
            if wave:
                if kind == "attach":
                    blocked = blocked or chunked or not (
                        full_hit and len(matched_pages) == attach_len)
                else:
                    blocked = blocked or chunked or bool(matched_pages)
            if blocked:
                if self.prefix_cache is not None:
                    self.prefix_cache.release(matched_entries)
                if skipped >= self.admit_reorder_window:
                    break
                skipped += 1
                scan += 1
                continue
            pages = self._try_alloc(n_pages - len(matched_pages),
                                    matched_entries)
            if pages is None:
                break  # pages exhausted: wait (no skip — alloc fairness)
            del self._pending[scan]
            slot = free[0]
            assigned.add(slot)
            if self.kvledger is not None:
                # the one allocation site: the pages become the slot's
                self.kvledger.on_alloc(pages, owner=req.group_id or req.rid)
            if self.prefix_cache is not None:
                self.prefix_cache.note_request(bool(matched_pages))
            if chunked:
                # a placeholder keeps the slot out of the free scan; it
                # stays inactive until the final chunk admits it
                self._slots[slot] = _SlotInfo(
                    req, list(pages), set(req.sampling.stop_token_ids),
                    cache_entries=list(matched_entries))
                self._chunk_jobs.append({
                    "req": req, "slot": slot, "pages": list(pages),
                    "matched_pages": list(matched_pages),
                    "matched_entries": list(matched_entries),
                    "budget": budget, "pos": prefix_cached, "own_filled": 0,
                    "version": self.weight_version, "first_key": first_key})
                chunk_keys.add(first_key)
                continue
            if not wave and matched_pages:
                if full_hit and self.group_share:
                    kind, attach_len = "attach", len(matched_pages)
                else:
                    # partial hit (or sharing disabled): singleton suffix
                    wave.append((req, slot, pages, budget, matched_pages,
                                 matched_entries))
                    break
            if not matched_pages and first_key is not None:
                wave_page_keys.add(first_key)
            wave.append((req, slot, pages, budget, matched_pages,
                         matched_entries))
        return wave, kind

    def _try_alloc(self, need: int, matched_entries: list):
        """Page allocation with the drain and cache-evict fallbacks; releases
        the caller's matched cache entries on failure."""
        pages = self.allocator.alloc(need)
        while pages is None and self._outstanding():
            # drain incrementally: finished slots return their pages, and
            # often the oldest output already holds the finisher
            self._drain_emit_q(keep=self._outstanding() - 1)
            pages = self.allocator.alloc(need)
        if pages is None and self.kvspill is not None:
            # spill unreferenced published KV to the host before evicting
            # it: a spill keeps what an eviction destroys
            if self._spill_pages(need - self.allocator.free_count,
                                 cold_only=False):
                pages = self.allocator.alloc(need)
        if pages is None and self.prefix_cache is not None:
            if self.prefix_cache.evict(need - self.allocator.free_count):
                pages = self.allocator.alloc(need)
            if pages is None:
                self.prefix_cache.release(matched_entries)
        return pages

    # -- host <-> device -------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device. On the card the copy starts from
        pinned memory and does not block: a copy from pageable memory waits
        for the stream, which would stall the host behind the run-ahead."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_host(self, tensors) -> tuple:
        """Queue the copy of fresh ``tensors`` to the host (pinned memory);
        returns an output payload: (event or None, host tensors, no ring
        slot), valid once the event has completed."""
        if self.device.type != "cuda":
            return None, tuple(tensors), None
        host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
        ev = torch.cuda.Event()
        ev.record()
        return ev, host, None

    @staticmethod
    def _pack_rows(head, page_rows, stop_rows) -> np.ndarray:
        """Packed int32 device-state rows: the ``_NI`` head columns (seq
        len, last token, generated, budget, active, top-k), then the
        page-table row and the stop-table row."""
        return np.concatenate([np.asarray(head), np.asarray(page_rows),
                               np.asarray(stop_rows)], axis=1).astype(np.int32)

    def _state_rows(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """Packed device-state rows of ``slots`` from the host mirrors:
        int32 [n, _NI + P + MAX_STOP_TOKENS] and float32 [n, 2]."""
        head = np.stack([self._seq_lens[slots], self._last_tokens[slots],
                         self._n_generated[slots], self._budgets[slots],
                         self._active[slots], self._top_ks[slots]], axis=1)
        floats = np.stack([self._temps[slots], self._top_ps[slots]], axis=1)
        return (self._pack_rows(head, self._page_table[slots],
                                self._stop_table[slots]),
                floats.astype(np.float32))

    def _dev_put(self, slots: np.ndarray, ints: torch.Tensor,
                 floats: torch.Tensor, last=None, active=None) -> None:
        """Write packed rows into the device state in place, at ``slots``;
        ``last``/``active`` (device tensors) take the place of those
        columns."""
        st, p = self._dev, self.pages_per_slot
        idx = self._tensor(np.asarray(slots, np.int64))
        cols = {"seq_lens": ints[:, _SEQ], "n_generated": ints[:, _NGEN],
                "budgets": ints[:, _BUDGET], "top_ks": ints[:, _TOPK],
                "last_tokens": ints[:, _LAST] if last is None else last,
                "active": ints[:, _ACTIVE] > 0 if active is None else active,
                "page_table": ints[:, _NI:_NI + p],
                "stop_table": ints[:, _NI + p:],
                "temps": floats[:, 0], "top_ps": floats[:, 1]}
        for name, src in cols.items():
            st[name].index_copy_(0, idx, src.to(st[name].dtype))

    def _ensure_dev_state(self) -> None:
        """Upload the host mirrors into the device state when a host event
        made it stale. A full drain comes first: queued outputs still carry
        device-side tokens the mirrors have not seen."""
        if not self._dev_stale:
            return
        self._drain_emit_q()
        slots = np.arange(self.max_slots)
        ints, floats = self._state_rows(slots)
        self._dev_put(slots, self._tensor(ints), self._tensor(floats))
        if self._hist is not None:
            # the spec token buffer, rebuilt from the history mirror: a
            # zeroed history would leave the output right and acceptance
            # collapsed
            buf = np.zeros(tuple(self._dev["tok_buf"].shape), np.int32)
            for i, h in enumerate(self._hist):
                if h:
                    n = min(len(h), self.max_seq_len)
                    buf[i, :n] = h[:n]
            self._dev["tok_buf"].copy_(self._tensor(buf))
        self._dev_stale = False

    def _put_history(self, slots: np.ndarray, seqs: list) -> None:
        """Write each admitted slot's prompt into its row of the spec token
        buffer (one scatter per admission wave); the sampled first token
        joins at the next spec round's splice."""
        width = min(max(len(x) for x in seqs), self.max_seq_len)
        rows = np.zeros((len(seqs), width), np.int32)
        for j, x in enumerate(seqs):
            n = min(len(x), width)
            rows[j, :n] = x[:n]
        self._dev["tok_buf"][:, :width].index_copy_(
            0, self._tensor(np.asarray(slots, np.int64)), self._tensor(rows))

    # -- prefill dispatches ------------------------------------------------------

    def _prefill_dispatch(self, wave: list, ids, lens, page_ids,
                          prefix_len: int = 0, prefix_ids=None):
        """One batched prefill (fresh, or suffix over cached prefix pages)
        plus first-token sampling; ``wave`` is [(req, slot, budget, page
        row)]. The admitted slots' rows go into the device state in place,
        queued after the dispatches in flight, with the sampled first
        tokens as their last tokens (a first token that is a stop token or
        exhausts the budget leaves the slot inactive). Returns the queued
        host copy of (tokens, logprobs, done)."""
        self._ensure_dev_state()
        params, cfg, pools = self.params, self.cfg, self._pools
        slots = np.array([w[1] for w in wave], np.int64)
        sps = [w[0].sampling for w in wave]
        ints = self._pack_rows(
            [(len(req.input_ids), self.pad_token_id, 1, budget, 1,
              req.sampling.top_k) for req, _s, budget, _r in wave],
            [w[3] for w in wave], [self._stops_row(sp) for sp in sps])
        iv = self._tensor(ints)
        fv = self._tensor(np.array([(sp.temperature, sp.top_p) for sp in sps],
                                   np.float32))
        if prefix_ids is None:
            _, last = decoder.prefill_batch_into_pages(
                params, cfg, self._tensor(ids), self._tensor(lens), pools,
                self._tensor(page_ids))
        else:
            _, last = decoder.prefill_suffix_batch_into_pages(
                params, cfg, self._tensor(ids), self._tensor(lens), prefix_len,
                pools, self._tensor(prefix_ids), self._tensor(page_ids))
        use_filters = any(sp.top_p < 1.0 or sp.top_k > 0 for sp in sps)
        token, logp = sample_token_vec(last, self._gen, fv[:, 0], fv[:, 1],
                                       iv[:, _TOPK], use_filters=use_filters)
        stops = iv[:, _NI + self.pages_per_slot:]
        done = ((token[:, None] == stops).any(dim=-1)
                | (iv[:, _BUDGET] <= 1))
        self._dev_put(slots, iv, fv, last=token, active=~done)
        if self._hist is not None:
            self._put_history(slots, [w[0].input_ids for w in wave])
        return self._to_host((token, logp, done))

    def _stops_row(self, sp: SamplingParams) -> np.ndarray:
        stops = np.full((MAX_STOP_TOKENS,), -1, np.int32)
        for i, t in enumerate(sp.stop_token_ids[:MAX_STOP_TOKENS]):
            stops[i] = t
        return stops

    def _page_row(self, pages: list[int]) -> np.ndarray:
        row = np.zeros((self.pages_per_slot,), np.int32)
        row[:len(pages)] = pages
        return row

    def _install_slot(self, slot: int, req: _Request, row: np.ndarray,
                      budget: int, private: list[int], entries: list,
                      cached_tokens: int = 0) -> None:
        """Host mirrors + slot record of a freshly prefilled request. Its
        first token stays on the device until the prefill's output is
        emitted (``_emit_prefill``); ``last_tokens`` is a placeholder.
        ``cached_tokens``: the prompt's prefix this admission did not
        compute (cache hit, chunk-filled pages), for the flight deck."""
        sp = req.sampling
        self._page_table[slot] = row
        self._seq_lens[slot] = len(req.input_ids)
        self._last_tokens[slot] = self.pad_token_id
        self._n_generated[slot] = 1
        self._budgets[slot] = budget
        self._active[slot] = True
        self._temps[slot] = sp.temperature
        self._top_ps[slot] = sp.top_p
        self._top_ks[slot] = sp.top_k
        self._stop_table[slot] = self._stops_row(sp)
        self._slots[slot] = _SlotInfo(req, list(private), set(sp.stop_token_ids),
                                      cache_entries=list(entries),
                                      admit_version=self.weight_version)
        if self._hist is not None:
            self._hist[slot] = list(req.input_ids)
        self._slot_gen[slot] += 1
        self.deck.on_admit(slot, req.rid, req.t_submit, len(req.input_ids),
                           cached_tokens=cached_tokens)

    def _enqueue_prefill(self, out, wave: list, kind: str, pb: int) -> None:
        """Queue an admission wave's first tokens for emission, tagged with
        each slot's new generation and the dispatch's weight version."""
        tail = [(slot, int(self._slot_gen[slot])) for _req, slot, *_ in wave]
        for req, *_ in wave:
            self.admissions.append((req.rid, kind, len(wave), pb))
        self._enqueue_output(("prefill", out, tail, self.weight_version))

    def _publish(self, req: _Request, all_pages: list[int], pages: list[int],
                 n_cached: int, matched_entries: list) -> tuple[list, list]:
        """Publish the prompt's freshly computed full pages; returns (the
        slot-private pages, the slot's cache refs)."""
        if self.prefix_cache is None:
            return list(pages), list(matched_entries)
        published = self.prefix_cache.publish(
            req.input_ids, all_pages, n_cached=n_cached,
            matched_entries=matched_entries)
        pub_pages = {e.page for _, e in published}
        if self.kvledger is not None:
            self.kvledger.on_publish(pub_pages)
        return ([p for p in pages if p not in pub_pages],
                list(matched_entries) + [e for _, e in published])

    def _prefill_request(self, slot: int, req: _Request, pages: list[int],
                         budget: int, matched_pages: list[int] | None = None,
                         matched_entries: list | None = None,
                         own_prefix_pages: int = 0) -> None:
        """Singleton admission: a fresh prompt, or the suffix of a (partial
        or full) prefix-cache hit attending over the matched pages.
        ``own_prefix_pages``: leading entries of ``pages`` whose KV is
        already filled (a chunk job's earlier chunks); they join the
        attended prefix and, unlike matched pages, are published as fresh
        pages."""
        matched_pages = matched_pages or []
        matched_entries = list(matched_entries or [])
        n_prompt = len(req.input_ids)
        prefix_pages = matched_pages + pages[:own_prefix_pages]
        prefix_len = len(prefix_pages) * self.page_size
        all_pages = matched_pages + pages
        suffix_len = n_prompt - prefix_len
        pb = next_bucket(suffix_len, self.prompt_buckets)
        n_sfx = -(-suffix_len // self.page_size)
        page_ids = np.zeros((1, pb // self.page_size), np.int32)
        page_ids[0, :n_sfx] = pages[own_prefix_pages:own_prefix_pages + n_sfx]
        ids = np.full((1, pb), self.pad_token_id, np.int32)
        ids[0, :suffix_len] = req.input_ids[prefix_len:]
        row = self._page_row(all_pages)
        out = self._prefill_dispatch(
            [(req, slot, budget, row)], ids,
            np.array([suffix_len], np.int32), page_ids, prefix_len=prefix_len,
            prefix_ids=(np.asarray([prefix_pages], np.int32)
                        if prefix_pages else None))
        private, entries = self._publish(req, all_pages, pages,
                                         len(matched_pages), matched_entries)
        self._consume_group_preref(req)
        self._register_group_prerefs(req, entries)
        self._register_decode_group(
            req, slot, max(0, (n_prompt - 1) // self.page_size), row)
        self._install_slot(slot, req, row, budget, private, entries,
                           cached_tokens=prefix_len)
        self._enqueue_prefill(out, [(req, slot)],
                              "suffix" if prefix_pages else "fresh", pb)

    def _advance_chunk_job(self) -> None:
        """One dispatch of the head chunk job: fill the next chunk's KV
        attending over the filled prefix (no sampling, no slot state), or,
        for the last chunk, the normal suffix admission, which samples the
        first token, activates the slot and publishes the prompt. A job is
        aborted on its abort event or a weight swap (its filled KV belongs
        to the old weights), never finished."""
        job = self._chunk_jobs[0]
        req = job["req"]
        if ((req.abort is not None and req.abort.is_set())
                or self.weight_version != job["version"]):
            self._chunk_jobs.popleft()
            self._finalize(job["slot"], cause="abort")
            self._emit_abort(req)
            return
        if len(req.input_ids) - job["pos"] <= self.prefill_chunk:
            self._chunk_jobs.popleft()
            self._slots[job["slot"]] = None  # _prefill_request installs it
            try:
                self._prefill_request(
                    job["slot"], req, job["pages"], job["budget"],
                    matched_pages=job["matched_pages"],
                    matched_entries=job["matched_entries"],
                    own_prefix_pages=job["own_filled"])
            except Exception:
                # the job left the deque and its placeholder: no other
                # path can clean it up
                self._free_slot_pages(job["pages"], "abort")
                if self.prefix_cache is not None:
                    self.prefix_cache.release(job["matched_entries"])
                self._emit_error(req, "prefill failed")
                raise
            return
        chunk, pos, own = self.prefill_chunk, job["pos"], job["own_filled"]
        ps = self.page_size
        prefix_pages = job["matched_pages"] + job["pages"][:own]
        n_chunk_pg = chunk // ps
        pb = next_bucket(chunk, self.prompt_buckets)
        ids = np.full((1, pb), self.pad_token_id, np.int32)
        ids[0, :chunk] = req.input_ids[pos:pos + chunk]
        page_ids = np.zeros((1, pb // ps), np.int32)
        page_ids[0, :n_chunk_pg] = job["pages"][own:own + n_chunk_pg]
        # on failure the job still heads the deque: _recover aborts it
        decoder.prefill_suffix_batch_into_pages(
            self.params, self.cfg, self._tensor(ids),
            self._tensor(np.array([chunk], np.int32)), pos, self._pools,
            self._tensor(np.asarray([prefix_pages], np.int32)),
            self._tensor(page_ids))
        self.chunk_dispatches += 1
        job["pos"] = pos + chunk
        job["own_filled"] = own + n_chunk_pg

    def _prefill_wave(self, wave: list) -> None:
        """Batched fresh admission: ONE forward prefills every prompt."""
        pb = next_bucket(max(len(r.input_ids) for r, *_ in wave),
                         self.prompt_buckets)
        b = len(wave)
        ids = np.full((b, pb), self.pad_token_id, np.int32)
        lens = np.zeros((b,), np.int32)
        page_ids = np.zeros((b, pb // self.page_size), np.int32)
        rows = []
        for j, (req, slot, pages, budget, *_rest) in enumerate(wave):
            n_prompt = len(req.input_ids)
            n_pp = -(-n_prompt // self.page_size)
            ids[j, :n_prompt] = req.input_ids
            lens[j] = n_prompt
            page_ids[j, :n_pp] = pages[:n_pp]
            rows.append((req, slot, budget, self._page_row(pages)))
        out = self._prefill_dispatch(rows, ids, lens, page_ids)
        for (req, slot, pages, budget, _mp, _me), (*_, row) in zip(wave, rows):
            private, entries = self._publish(req, pages, pages, 0, [])
            self._consume_group_preref(req)
            self._register_group_prerefs(req, entries)
            # leader seat: its first full prompt pages ARE the chain the
            # siblings will attach to (publish keeps the ids)
            self._register_decode_group(
                req, slot, max(0, (len(req.input_ids) - 1) // self.page_size),
                row)
            self._install_slot(slot, req, row, budget, private, entries)
        self._enqueue_prefill(out, [(w[0], w[1]) for w in wave], "fresh", pb)

    def _prefill_attach_wave(self, wave: list) -> None:
        """Batched sibling attach: every member is a FULL prefix hit with
        the same prefix page count; one suffix forward admits them all.
        Full hits publish nothing, so their pages stay slot-private and
        their cache refs are exactly the ``match()`` entries."""
        attach_pages = len(wave[0][4])
        prefix_len = attach_pages * self.page_size
        pb = next_bucket(max(len(r.input_ids) - prefix_len for r, *_ in wave),
                         self.prompt_buckets)
        b = len(wave)
        ids = np.full((b, pb), self.pad_token_id, np.int32)
        lens = np.zeros((b,), np.int32)
        page_ids = np.zeros((b, pb // self.page_size), np.int32)
        prefix_ids = np.zeros((b, attach_pages), np.int32)
        rows = []
        for j, (req, slot, pages, budget, mp, _me) in enumerate(wave):
            sfx = len(req.input_ids) - prefix_len
            ids[j, :sfx] = req.input_ids[prefix_len:]
            lens[j] = sfx
            n_sfx = -(-sfx // self.page_size)
            page_ids[j, :n_sfx] = pages[:n_sfx]
            prefix_ids[j] = mp
            rows.append((req, slot, budget, self._page_row(mp + pages)))
        out = self._prefill_dispatch(rows, ids, lens, page_ids,
                                     prefix_len=prefix_len,
                                     prefix_ids=prefix_ids)
        for (req, slot, pages, budget, _mp, me), (*_, row) in zip(wave, rows):
            self._consume_group_preref(req)
            # sibling seat: the matched pages are the leader's chain
            self._register_decode_group(req, slot, attach_pages, row)
            self._install_slot(slot, req, row, budget, pages, me,
                               cached_tokens=prefix_len)
        self.sibling_attach_dispatches += 1
        self.group_forked_requests += len(wave)
        self._enqueue_prefill(out, [(w[0], w[1]) for w in wave], "attach", pb)

    # -- group-shared prefill pre-refs ---------------------------------------

    def _register_group_prerefs(self, req: _Request, entries: list) -> None:
        """After a group leader's prompt pages publish, pre-take
        ``group_size - 1`` refs on the chain so pool-pressure eviction can't
        reclaim the shared prefix before the siblings attach."""
        if (not self.group_share or self.prefix_cache is None
                or not req.group_id or req.group_size <= 1 or not entries
                or req.group_id in self._group_prerefs):
            return
        n = req.group_size - 1
        self.prefix_cache.retain(entries, n)
        self._group_prerefs[req.group_id] = {
            "entries": list(entries), "remaining": n, "t": time.monotonic()}
        if self.kvledger is not None:
            self.kvledger.on_preref_hold([e.page for e in entries])

    def _preref_released(self, g: dict) -> None:
        """A group's pre-refs are gone: its pinned pages fall back to
        plain published in the ledger."""
        if self.kvledger is not None:
            self.kvledger.on_preref_release([e.page for e in g["entries"]])

    def _consume_group_preref(self, req: _Request) -> None:
        """One group member accounted for (admitted, aborted or refused):
        drop one pre-ref unit on the group's chain."""
        if not req.group_id:
            return
        g = self._group_prerefs.get(req.group_id)
        if g is None:
            return
        if self.prefix_cache is not None:
            self.prefix_cache.release(g["entries"])
        g["remaining"] -= 1
        if g["remaining"] <= 0:
            del self._group_prerefs[req.group_id]
            self._preref_released(g)

    def _sweep_group_prerefs(self) -> None:
        """Expire pre-refs of groups whose siblings never arrived."""
        now = time.monotonic()
        for gid in [g for g, v in self._group_prerefs.items()
                    if now - v["t"] > self.group_preref_ttl_s]:
            g = self._group_prerefs.pop(gid)
            if self.prefix_cache is not None:
                for _ in range(max(0, g["remaining"])):
                    self.prefix_cache.release(g["entries"], cause="preref_ttl")
            self._preref_released(g)

    def _disband_group_prerefs(self) -> None:
        """Release every outstanding pre-ref (before any cache flush)."""
        for g in self._group_prerefs.values():
            if self.prefix_cache is not None:
                for _ in range(max(0, g["remaining"])):
                    self.prefix_cache.release(g["entries"])
            self._preref_released(g)
        self._group_prerefs.clear()

    # -- shared-prefix decode groups -----------------------------------------

    def _register_decode_group(self, req: _Request, slot: int,
                               n_pre_pages: int, prefix_pages) -> None:
        """Seat ``slot`` in its GRPO group's decode-sharing table, only when
        its leading page-table columns are the group's exact physical
        prefix chain (a member re-prefilled onto fresh pages after a cache
        flush decodes solo, still correctly)."""
        if (not self.decode_group_share or not self.group_share
                or self.prefix_cache is None or not req.group_id
                or req.group_size <= 1 or n_pre_pages <= 0):
            return
        pages_t = tuple(int(p) for p in list(prefix_pages)[:n_pre_pages])
        if len(pages_t) < n_pre_pages:
            return
        g = self._decode_groups.get(req.group_id)
        if g is None or not g["slots"]:
            g = {"n_pre": int(n_pre_pages), "pages": pages_t, "slots": set()}
            self._decode_groups[req.group_id] = g
        if g["n_pre"] != n_pre_pages or g["pages"] != pages_t:
            return
        g["slots"].add(slot)
        self._slot_decode_gid[slot] = req.group_id

    def _drop_decode_seat(self, slot: int) -> None:
        gid = self._slot_decode_gid.pop(slot, None)
        if gid is None:
            return
        g = self._decode_groups.get(gid)
        if g is not None:
            g["slots"].discard(slot)
            if not g["slots"]:
                del self._decode_groups[gid]

    def _decode_group_pack(self):
        """This dispatch's decode-group tables (group_slots [NG, G] with -1
        empty seats, prefix pages [NG, P_pre], prefix token counts [NG]),
        or None when no group has >= 2 active members. Every dimension is
        bucketed to a power of two, as in the JAX engine."""
        if not self.decode_group_share:
            return None
        rows = []
        for g in self._decode_groups.values():
            live = sorted(s for s in g["slots"] if self._active[s])
            if len(live) >= 2:
                rows.append((live, g["n_pre"], g["pages"]))
        if not rows:
            return None
        ng = _pow2(len(rows))
        gmax = _pow2(max(len(r[0]) for r in rows))
        p_pre = _pow2(max(r[1] for r in rows))
        g_slots = np.full((ng, gmax), -1, np.int32)
        g_pages = np.zeros((ng, p_pre), np.int32)
        g_lens = np.zeros((ng,), np.int32)
        for i, (live, n_pre, pages) in enumerate(rows):
            g_slots[i, :len(live)] = live
            g_pages[i, :n_pre] = pages[:n_pre]
            g_lens[i] = n_pre * self.page_size
        return g_slots, g_pages, g_lens

    # -- decode --------------------------------------------------------------

    def _step_once(self) -> None:
        # host-side aborts flip slots inactive before the next dispatch
        if any(info is not None and self._active[i]
               and info.req.abort is not None and info.req.abort.is_set()
               for i, info in enumerate(self._slots)):
            if self.salvage_partials:
                self._abort_with_salvage()
            else:
                self._abort_fast()
        if not self._active.any():
            self._drain_emit_q()
            return
        # tail cutoff: when every active slot's remaining budget is covered
        # by dispatches already in flight for it, another dispatch could
        # only compute pad rows -- wait for an output to land instead.
        # Exact for budget-bound streams; a stop-token finish may still run
        # ahead (the device's early out is not visible to the host yet).
        rem = int(np.max((self._budgets - self._n_generated
                          - self._inflight_tok)[self._active]))
        if rem <= 0:
            out = self._outstanding()
            if out:
                self._drain_emit_q(keep=out - 1)
            return
        with self._phase("decode_dispatch_device"):
            self._ensure_dev_state()  # may drain, which may finish slots
        if not self._active.any():
            return
        use_filters = bool(np.any((self._top_ps[self._active] < 1.0)
                                  | (self._top_ks[self._active] > 0)))
        if self.spec_tokens > 0:
            self._spec_step_once(use_filters)
            return
        tables = self._decode_group_pack()
        idxs = [(int(i), int(self._slot_gen[i]))
                for i in np.flatnonzero(self._active)]
        t0 = time.monotonic()
        with self._phase("decode_dispatch_device"):
            self._launch_decode(use_filters, tables)
            out = self._ring_copy()
        self.decode_host_s += time.monotonic() - t0
        self.decode_dispatches += 1
        if tables is not None:
            self.grouped_decode_dispatches += 1
        k = self.steps_per_dispatch
        with self._phase("accounting"):
            self._account_kv_reads(tables, k)
        self._inflight_tok[self._active] += k
        self._enqueue_output(("step", out, idxs, k, self.weight_version))
        with self._phase("accounting"):
            self._deck_dispatch()
        # run ahead up to pipeline_depth dispatches: older outputs land on
        # the fetcher while the device computes the newer ones
        self._drain_emit_q(keep=self.pipeline_depth)

    def _group_tables(self, tables):
        """The group tables in the static device buffers of their shape
        (a captured graph reads these very tensors): (slots, prefix pages,
        prefix lengths), or None."""
        if tables is None:
            return None
        g_slots, g_pages, g_lens = tables
        (ng, gmax), p_pre = g_slots.shape, g_pages.shape[1]
        buf = self._gbufs.get((ng, gmax, p_pre))
        if buf is None:
            buf = torch.zeros((ng * (gmax + p_pre + 1),), dtype=torch.int32,
                              device=self.device)
            self._gbufs[(ng, gmax, p_pre)] = buf
        buf.copy_(self._tensor(np.concatenate(
            [g_slots.ravel(), g_pages.ravel(), g_lens])))
        a, b = ng * gmax, ng * (gmax + p_pre)
        return (buf[:a].view(ng, gmax), buf[a:b].view(ng, p_pre), buf[b:])

    def _spec_step_once(self, use_filters: bool) -> None:
        """One speculative decode dispatch (``spec_rounds`` rounds), queued
        and run ahead like a k-step dispatch: every round emits at least
        one token per active slot, which is what the tail cutoff counts."""
        m = self.spec_tokens + 1
        idxs = [(int(i), int(self._slot_gen[i]))
                for i in np.flatnonzero(self._active)]
        t0 = time.monotonic()
        with self._phase("decode_dispatch_device"):
            self._launch(self._spec_key(use_filters),
                         lambda: self._spec_body(use_filters))
            out = self._ring_copy()
        self.decode_host_s += time.monotonic() - t0
        self.decode_dispatches += 1
        self.spec_dispatches += 1
        self.spec_token_ceiling += len(idxs) * self.spec_rounds * m
        # verify attends m rows per slot per round, over the slot's own
        # pages; tokens counted at the one-per-round emission floor
        with self._phase("accounting"):
            self._account_kv_reads(None, self.spec_rounds * m,
                                   k_tokens=self.spec_rounds)
        self._inflight_tok[self._active] += self.spec_rounds
        self._enqueue_output(("spec", out, idxs, self.spec_rounds,
                              self.weight_version))
        with self._phase("accounting"):
            self._deck_dispatch()
        self._drain_emit_q(keep=self.pipeline_depth)

    def _account_kv_reads(self, tables, k: int,
                          k_tokens: int | None = None) -> None:
        """The dispatch's KV-read sample for the flight deck, from the host
        mirrors: logical pages = what every active slot attends; streamed =
        what the kernels read, each decode group's prefix chain once
        instead of once per member (K3). Page counts are taken at dispatch
        (each of the k steps may cross one page boundary more)."""
        active_idx = np.flatnonzero(self._active)
        if active_idx.size == 0:
            return
        logical = int((self._seq_lens[active_idx] // self.page_size + 1).sum())
        streamed = logical
        if tables is not None:
            g_slots, _g_pages, g_lens = tables
            for live, n_pre in zip((g_slots >= 0).sum(axis=1),
                                   g_lens // self.page_size):
                streamed -= max(0, int(live) - 1) * int(n_pre)
        self.deck.on_kv_read(
            streamed * k, logical * k,
            int(active_idx.size) * (k if k_tokens is None else k_tokens))

    def _deck_dispatch(self) -> None:
        """After each decode dispatch: the flight deck's occupancy and page
        pressure sample; the ledger's touch of every active slot's page row
        (what the dispatch attends) and its tier sweep; then the spill
        sweep."""
        self.deck.on_dispatch(
            int(self._active.sum()), self.allocator.free_count,
            self._cache_pages(), self._outstanding(), len(self._pending))
        if self.kvledger is not None:
            rows = self._page_table[self._active].ravel()
            self.kvledger.on_dispatch(rows[rows != 0])
            if self.kvspill is not None:
                self._spill_sweep()

    def _spec_key(self, use_filters: bool) -> tuple:
        """The spec dispatch's graph key, the JAX spec step's jit key."""
        return ("spec", use_filters, self.spec_tokens + 1, self.spec_rounds)

    @property
    def spec_accept_rate(self) -> float:
        """Emitted tokens over what the spec dispatches could have emitted
        (each active slot ``spec_rounds * (spec_tokens + 1)``); 0.0 before
        any spec dispatch, ``1 / (spec_tokens + 1)`` with no draft ever
        accepted."""
        if self.spec_token_ceiling <= 0:
            return 0.0
        return self.spec_emitted / self.spec_token_ceiling

    def _launch_decode(self, use_filters: bool, tables) -> None:
        """Queue one k-step decode dispatch on the current stream (see
        ``_launch``)."""
        gt = self._group_tables(tables)
        self._launch(self._graph_key(use_filters, tables),
                     lambda: self._decode_body(use_filters, gt))

    def _launch(self, key: tuple, body) -> None:
        """Queue one decode dispatch on the current stream. On the card: the
        replay of its key's CUDA graph, or, for a key not seen yet, the
        eager body on the side stream (the warm-up: it is this dispatch)
        and then the capture of the key's graph. On the CPU the eager
        body."""
        if not self._use_graphs:
            body()
            return
        entry = self._graphs.get(key)
        if entry is not None:
            graph, launches = entry
            graph.replay()
            cuda_build.credit_launches(launches)
            self.graph_replays += 1
            return
        self._warm_up(body)
        t0 = time.monotonic()
        with cuda_build.recording_launches() as launches:
            graph = self._capture(body)
        self._graphs[key] = (graph, launches)
        self.graph_captures += 1
        self.graph_capture_s += time.monotonic() - t0
        log.info("captured decode graph %s in %.2f s (%s)", key,
                 time.monotonic() - t0, launches)

    def _graph_key(self, use_filters: bool, tables) -> tuple:
        """A dispatch's graph key, the JAX step's jit key: (use_filters, k,
        group shape (ng, gmax, p_pre) or None)."""
        gshape = None if tables is None else (
            tables[0].shape[0], tables[0].shape[1], tables[1].shape[1])
        return (use_filters, self.steps_per_dispatch, gshape)

    def _warm_up(self, body) -> None:
        """Run ``body`` eagerly on the side stream that captures, ordered
        after and before the current stream's work: the first dispatch of
        a key, which also sets up what a capture may not (cuBLAS's
        workspace for that stream, lazily uploaded constants)."""
        if self.device.type != "cuda":
            body()
            return
        cur = torch.cuda.current_stream(self.device)
        self._side_stream.wait_stream(cur)
        with torch.cuda.stream(self._side_stream):
            body()
        cur.wait_stream(self._side_stream)

    def _capture(self, body) -> "torch.cuda.CUDAGraph":
        """Capture ``body`` into a CUDA graph on the side stream, with the
        sampling generator's state registered, so that every replay draws
        fresh uniforms from it and advances it. Capture runs on this
        thread only (``thread_local``): another thread's CUDA calls, the
        pipelined trainer's, go on; but a capture also registers the
        default CUDA generator, so another thread must not draw from that
        one meanwhile (the port never does). All graphs share one memory
        pool."""
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "CUDAGraph.register_generator_state is missing in this "
                "PyTorch: a replay would repeat the captured draws of the "
                "engine's sampling generator")
        graph.register_generator_state(self._gen)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              stream=self._side_stream,
                              capture_error_mode="thread_local"):
            body()
        return graph

    @torch.no_grad()
    def _decode_body(self, use_filters: bool, gt) -> None:
        """``steps_per_dispatch`` fused decode steps with the state advanced
        on the device, in place (the JAX ``_get_step`` scan body). Slots
        that finish mid-dispatch go inactive: their later rows carry pad
        tokens and their KV writes go to the null page. Writes the [k, S]
        outputs into ``self._out``. Reads nothing on the host, so that it
        can be captured."""
        st, pad = self._dev, self.pad_token_id
        params, cfg = self.params, self.cfg
        attn = None  # forward_paged_decode's default: paged_attention
        if gt is not None:
            g_slots, g_pages, g_lens = gt

            def attn(q, kp, vp, pt, lens):
                return grouped_paged_attention(q, kp, vp, pt, lens, g_slots,
                                               g_pages, g_lens)
        page_table, stop_table, budgets = (st["page_table"], st["stop_table"],
                                           st["budgets"])
        seq_lens, last = st["seq_lens"], st["last_tokens"]
        n_gen, active = st["n_generated"], st["active"]
        out_tok, out_lp, out_done = self._out
        for i in range(self.steps_per_dispatch):
            logits, _ = decoder.forward_paged_decode(
                params, cfg, last, seq_lens, self._pools, page_table, seq_lens,
                attn_fn=attn, active=active)
            token, logp = sample_token_vec(logits, self._gen, st["temps"],
                                           st["top_ps"], st["top_ks"],
                                           use_filters=use_filters)
            n_gen = n_gen + active.int()
            hit_stop = (token[:, None] == stop_table).any(dim=-1)
            done = active & (hit_stop | (n_gen >= budgets))
            token = torch.where(active, token, pad)
            logp = torch.where(active, logp, 0.0)
            seq_lens = seq_lens + active.int()
            last = torch.where(active, token, last)
            active = active & ~done
            out_tok[i].copy_(token)
            out_lp[i].copy_(logp)
            out_done[i].copy_(done)
        for name, val in (("seq_lens", seq_lens), ("last_tokens", last),
                          ("n_generated", n_gen), ("active", active)):
            st[name].copy_(val)

    @torch.no_grad()
    def _spec_body(self, use_filters: bool) -> None:
        """``spec_rounds`` speculation rounds with the state advanced on the
        device, in place (the JAX ``_get_spec_step`` scan body). Each
        round splices the newest token into the token buffer, proposes
        ``m - 1`` drafts by n-gram lookup, verifies all ``m`` tokens in one
        ``forward_paged_decode`` over ``S * m`` virtual rows (row ``(s, i)``
        at position ``seq_lens[s] + i`` on slot ``s``'s page row; within a
        layer every row's K/V is written before attention reads, which
        gives exact causal semantics; rows past the slot's pages or of
        inactive slots write to the null page), rejection-samples, applies
        the stop and budget semantics over the accepted prefix in order,
        and writes the emitted tokens back into the buffer. Writes the
        ``[rounds * m, S]`` outputs and the ``emitted`` mask into
        ``self._out``; reads nothing on the host, so that it can be
        captured."""
        st, pad = self._dev, self.pad_token_id
        params, cfg = self.params, self.cfg
        m = self.spec_tokens + 1
        buf = st["tok_buf"]
        s, buf_len = buf.shape
        dev = buf.device
        rows = torch.arange(s, device=dev)
        page_table, stop_table, budgets = (st["page_table"], st["stop_table"],
                                           st["budgets"])
        max_pos = page_table.shape[1] * self.page_size
        pt_rep = page_table.repeat_interleave(m, dim=0)
        steps = torch.arange(m, dtype=torch.int32, device=dev)
        seq_lens, last = st["seq_lens"], st["last_tokens"]
        n_gen, active = st["n_generated"], st["active"]
        out_tok, out_lp, out_done, out_emit = self._out
        for r in range(self.spec_rounds):
            buf[rows, seq_lens.long().clamp(0, buf_len - 1)] = last
            draft = device_ngram_propose(buf, seq_lens + 1, m - 1)
            tokens_in = torch.cat([last[:, None], draft], dim=1)
            pos = seq_lens[:, None] + steps[None]
            ok = (pos < max_pos) & active[:, None]
            flat_pos = pos.reshape(-1)
            logits, _ = decoder.forward_paged_decode(
                params, cfg, tokens_in.reshape(-1), flat_pos, self._pools,
                pt_rep, flat_pos, active=ok.reshape(-1))
            toks, logps, n_acc = spec_verify_sample_vec(
                logits.reshape(s, m, -1), draft, self._gen, st["temps"],
                st["top_ps"], st["top_ks"], use_filters=use_filters)
            stopped = torch.zeros_like(active)
            emit_cnt = torch.zeros_like(seq_lens)
            emits = []
            for i in range(m):
                want = active & ~stopped & (n_acc >= i)
                tok_i = torch.where(want, toks[:, i], pad)
                n_gen = n_gen + want.int()
                hit = (tok_i[:, None] == stop_table).any(dim=-1) & want
                done_i = want & (hit | (n_gen >= budgets))
                out_tok[r * m + i].copy_(tok_i)
                out_lp[r * m + i].copy_(torch.where(want, logps[:, i], 0.0))
                out_done[r * m + i].copy_(done_i)
                out_emit[r * m + i].copy_(want)
                stopped = stopped | done_i
                emit_cnt = emit_cnt + want.int()
                last = torch.where(want, toks[:, i], last)
                emits.append(want)
            # the emitted tokens into the history at seq_len + 1 ... (rows
            # not emitted write their current value back)
            widx = (pos + 1).long().clamp(0, buf_len - 1)
            buf.scatter_(1, widx, torch.where(torch.stack(emits, dim=1), toks,
                                              buf.gather(1, widx)))
            seq_lens = seq_lens + emit_cnt
            active = active & ~stopped
        for name, val in (("seq_lens", seq_lens), ("last_tokens", last),
                          ("n_generated", n_gen), ("active", active)):
            st[name].copy_(val)

    def _ring_copy(self):
        """Queue the copy of the dispatch's outputs into a free slot of the
        pinned host ring; returns (event or None, host arrays, ring slot)."""
        while True:
            with self._fetch_cv:
                j = self._ring_free.popleft() if self._ring_free else None
            if j is not None:
                break
            # every ring slot awaits emission (a run-ahead window wider
            # than the ring): emit the oldest output
            self._drain_emit_q(keep=self._outstanding() - 1)
        host = self._ring[j]
        for h, d in zip(host, self._out):
            h.copy_(d, non_blocking=True)
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        return ev, host, j

    def _abort_fast(self) -> None:
        """Abort every active slot whose request's abort event is set: the
        terminal ``abort`` line first and the slot generation bumped, so
        queued outputs for it are dropped at emission; then a full barrier
        before the pages go back (dispatches in flight still write KV
        through the old device page table), and the device state is
        uploaded again before its next use."""
        aborted: list[int] = []
        for i, info in enumerate(self._slots):
            if info is None or not self._active[i]:
                continue
            if info.req.abort is not None and info.req.abort.is_set():
                self._active[i] = False
                self._slot_gen[i] += 1
                self._emit_abort(info.req)
                aborted.append(i)
        if aborted:
            # finally: a raising drain goes to _recover, whose sweep only
            # sees mirror-active slots -- these must still be finalized
            try:
                self._drain_emit_q()
            finally:
                for i in aborted:
                    self._finalize(i, cause="abort")
                self._dev_stale = True
        self.num_running = int(self._active.sum())

    def _abort_with_salvage(self) -> None:
        """Abort with salvage: the aborted slots stay active through a full
        drain, so every token the dispatches in flight already decoded
        streams to the client; then the ``abort`` terminal. A slot that
        finished (stop or budget) during the drain is left alone. The
        drain is the barrier before any page returns to the allocator;
        the slots' full pages are published to the prefix cache so that a
        continuation (prompt + partial) re-uses the KV."""
        aborted = [i for i, info in enumerate(self._slots)
                   if info is not None and self._active[i]
                   and info.req.abort is not None and info.req.abort.is_set()]
        before = {i: len(self._slots[i].emitted) for i in aborted}
        try:
            self._drain_emit_q()
        finally:
            for i in aborted:
                info = self._slots[i]
                if info is None or not self._active[i]:
                    continue  # finished during the drain
                self.tokens_salvaged += len(info.emitted) - before[i]
                self._active[i] = False
                self._slot_gen[i] += 1
                # finally: the terminal reaches the client even if the
                # bookkeeping raises (the slot is inactive already, so
                # _recover's sweep would not see it)
                try:
                    self._salvage_publish(i, info)
                    self.deck.on_salvage(i)
                    self._finalize(i, cause="salvage")
                finally:
                    self._emit_abort(info.req)
            self._dev_stale = True
        self.num_running = int(self._active.sum())

    def _salvage_publish(self, slot: int, info: _SlotInfo) -> None:
        """Publish an aborted slot's full pages (prompt + generated tokens)
        to the prefix cache: a continuation's prompt is this very sequence,
        so its suffix prefill matches them. Skipped for a slot admitted
        under older weights (its KV predates the flush of the swap) and for
        a slot that emitted nothing."""
        if (self.prefix_cache is None
                or info.admit_version != self.weight_version
                or not info.emitted):
            return
        seq = list(info.req.input_ids) + [int(t) for t in info.emitted]
        n_full = max(0, (len(seq) - 1) // self.page_size)
        if n_full == 0:
            return
        page_row = [int(p) for p in self._page_table[slot][:n_full]]
        matched_pages, matched_entries = self.prefix_cache.match(seq)
        if any(e.spilled for e in matched_entries):
            # salvage pays no restore to dedup its publish: the verified
            # chain is cut at its first spilled entry, and publish walks on
            # past the spilled entries by token and parent identity
            cut = next(i for i, e in enumerate(matched_entries) if e.spilled)
            self.prefix_cache.release(matched_entries[cut:])
            matched_pages = matched_pages[:cut]
            matched_entries = matched_entries[:cut]
        published = self.prefix_cache.publish(
            seq, page_row, n_cached=len(matched_pages),
            matched_entries=matched_entries)
        # the published pages now belong to the cache; _finalize frees the
        # rest of the slot's private pages
        pub_pages = {e.page for _, e in published}
        info.pages = [p for p in info.pages if p not in pub_pages]
        self.salvage_published_pages += len(pub_pages)
        if self.kvledger is not None:
            self.kvledger.on_publish(pub_pages)
        # drop the refs this round took (match and publish): the entries
        # stay cached, unreferenced and evictable
        self.prefix_cache.release(matched_entries + [e for _, e in published])

    # -- the emission queue and the fetcher thread -----------------------------

    def _enqueue_output(self, entry) -> None:
        """Queue a dispatch's output for the fetcher (wakes it). An entry is
        (kind, (event, host tensors, ring slot), tail, ..., weight
        version)."""
        with self._fetch_cv:
            self._emit_q.append(entry)
            self._fetch_cv.notify_all()

    def _outstanding(self) -> int:
        """Dispatch outputs not yet emitted (queued, being fetched, landed)."""
        with self._fetch_cv:
            return (len(self._emit_q) + self._fetch_inflight
                    + len(self._fetched_q))

    def _release(self, entry) -> None:
        """An output left the queue (emitted or dropped): its ring slot may
        be reused. Called under ``_fetch_cv``."""
        j = entry[1][2]
        if j is not None:
            self._ring_free.append(j)

    @staticmethod
    def _land(entry) -> tuple:
        """Wait for an output's copy to reach the host: its arrays."""
        ev, host, _j = entry[1]
        if ev is not None:
            ev.synchronize()
        return tuple(h.numpy() for h in host)

    def _fetch_loop(self) -> None:
        """Fetcher thread: waits for each queued output's copy, oldest
        first (an event wait, which releases the interpreter lock), and
        hands the host arrays back to the loop thread, which emits them."""
        cv = self._fetch_cv
        while not self._stop.is_set():
            with cv:
                if not self._emit_q:
                    cv.wait(timeout=0.05)
                    continue
                entry = self._emit_q.popleft()
                self._fetch_inflight = 1
                epoch = self._fetch_epoch
            handed_off = False
            try:
                try:
                    arrs = self._land(entry)
                except Exception as exc:  # noqa: BLE001 — surface on the
                    # loop thread (next drain), where _recover resets
                    with cv:
                        self._fetch_inflight = 0
                        self._release(entry)
                        if epoch == self._fetch_epoch:
                            self._fetch_exc = exc
                        cv.notify_all()
                    handed_off = True
                    continue
                with cv:
                    self._fetched_q.append((epoch, entry, arrs))
                    self._fetch_inflight = 0
                    cv.notify_all()
                handed_off = True
            finally:
                if not handed_off:
                    # a BaseException is ending this thread mid-fetch:
                    # requeue the entry in front so the loop thread's
                    # dead-fetcher path lands it (FIFO kept)
                    with cv:
                        self._emit_q.appendleft(entry)
                        self._fetch_inflight = 0
                        cv.notify_all()

    def _drain_emit_q(self, keep: int = 0) -> None:
        """Emit every output the fetcher has landed, bringing the host
        mirrors up to date; block until at most ``keep`` outputs remain
        unemitted. ``keep=0`` is the full barrier a state upload needs;
        ``keep=pipeline_depth`` the steady-state call that only throttles
        the loop when the device runs too far ahead."""
        if self._fetch_thread is None:
            # engine not started (tests drive internals directly): land
            # the oldest beyond ``keep`` on this thread
            self._fetch_sync(keep)
        cv = self._fetch_cv
        while True:
            with cv:
                ready = list(self._fetched_q)
                self._fetched_q.clear()
                exc, self._fetch_exc = self._fetch_exc, None
                epoch = self._fetch_epoch
                for _ep, entry, _a in ready:
                    self._release(entry)
            if ready:
                with self._phase("emit"):
                    for ep, entry, arrs in ready:
                        if ep == epoch:
                            self._emit_entry(entry, arrs)
            if exc is not None:
                raise exc
            with cv:
                if (len(self._emit_q) + self._fetch_inflight
                        + len(self._fetched_q) <= keep):
                    return
            fetcher_dead = (self._fetch_thread is not None
                            and not self._fetch_thread.is_alive())
            if self._stop.is_set() or fetcher_dead:
                # the fetcher exits on stop() with entries queued, or died:
                # land them here. FIFO: wait out a fetch under way first.
                with cv:
                    if self._fetch_inflight:
                        with self._phase("sample_fetch"):
                            cv.wait(timeout=0.2)
                        continue
                self._fetch_sync(keep)
                continue
            with cv:
                if not self._fetched_q and (self._emit_q
                                            or self._fetch_inflight):
                    with self._phase("sample_fetch"):
                        cv.wait(timeout=0.2)

    def _fetch_sync(self, keep: int = 0) -> None:
        """Land the queued outputs beyond ``keep`` (oldest first) on this
        thread."""
        with self._fetch_cv:
            n = len(self._emit_q) - keep
            batch = [self._emit_q.popleft() for _ in range(max(0, n))]
            epoch = self._fetch_epoch
        with self._phase("sample_fetch"):
            landed = [(epoch, e, self._land(e)) for e in batch]
        with self._fetch_cv:
            self._fetched_q.extend(landed)

    def _emit_entry(self, entry, arrs) -> None:
        kind, _payload, tail = entry[:3]
        # the version of the weights that sampled these tokens: the one at
        # dispatch, not the one live when the output lands
        wv = entry[-1]
        if kind in ("step", "spec"):
            for slot, gen in tail:
                # a finalized and reused slot zeroed its count: stale
                # decrements for the old request must not starve the new
                if self._slot_gen[slot] == gen:
                    self._inflight_tok[slot] = max(
                        0, self._inflight_tok[slot] - entry[3])
            self._emit_fetched(*arrs[:3], tail, wv,
                               emitted=arrs[3] if kind == "spec" else None)
        else:
            token, logp, done = arrs
            for j, slot_gen in enumerate(tail):
                self._emit_prefill(int(token[j]), float(logp[j]),
                                   bool(done[j]), slot_gen, wv)

    # -- emission ------------------------------------------------------------

    def _emit_prefill(self, t: int, lp: float, device_done: bool,
                      tail: tuple[int, int], wv: int) -> None:
        """Deliver an admitted request's first token (its prefill's output,
        emitted from the queue)."""
        slot, gen = tail
        info = self._slots[slot]
        if info is None or self._slot_gen[slot] != gen:
            return
        stop_hit = t in info.stop_set
        fin = device_done or stop_hit
        reason = "stop" if stop_hit else ("length" if fin else "")
        info.req.out.put({"token_ids": [t], "logprobs": [lp],
                          "finished": fin, "finish_reason": reason,
                          "weight_version": wv})
        self._last_tokens[slot] = t
        info.emitted.append(t)
        if self._hist is not None:
            self._hist[slot].append(t)
        self.deck.on_first_token(slot)
        self._count_tokens(1)
        if fin:
            # finalize before the terminal marker: a client that saw
            # STREAM_END may read the flight deck at once
            self._active[slot] = False
            try:
                self._finalize(slot)
            finally:
                info.req.out.put(STREAM_END)
            if not device_done:
                # a stop token beyond the device table: its active flag is
                # stale
                self._dev_stale = True
        self.num_running = int(self._active.sum())

    def _emit_fetched(self, token, logp, done, idxs, wv: int,
                      emitted=None) -> None:
        """Stream one dispatch's [rows, S] outputs to the requests; ``idxs``
        is the (slot, generation) pairs active at dispatch. Slots that
        finished in an earlier row (the pad tail) or earlier output, and
        reused slots (generation mismatch), are skipped; so are rows a
        spec dispatch did not emit (``emitted`` false: a rejected
        draft)."""
        n_emitted = 0
        finished: list[int] = []
        host_stop_fix = False
        for r in range(token.shape[0]):
            for i, gen in idxs:
                info = self._slots[i]
                if info is None or not self._active[i] or self._slot_gen[i] != gen:
                    continue
                if emitted is not None and not emitted[r, i]:
                    continue
                t = int(token[r, i])
                # the host check is authoritative: stop tokens beyond the
                # MAX_STOP_TOKENS device table finish here too
                fin = bool(done[r, i]) or t in info.stop_set
                reason = ""
                if fin:
                    reason = "stop" if t in info.stop_set else "length"
                info.req.out.put({"token_ids": [t],
                                  "logprobs": [float(logp[r, i])],
                                  "finished": fin, "finish_reason": reason,
                                  "weight_version": wv})
                n_emitted += 1
                self._seq_lens[i] += 1
                self._last_tokens[i] = t
                self._n_generated[i] += 1
                info.emitted.append(t)
                self.deck.on_decode(i)
                if self._hist is not None:
                    self._hist[i].append(t)
                if fin:
                    self._active[i] = False
                    finished.append(i)
                    # the device missed this stop (beyond its table): its
                    # active flag is stale. A dispatch in flight writes one
                    # more token into the freed pages, which is safe: a
                    # later prefill reusing them is queued after it.
                    host_stop_fix |= not bool(done[r, i])
        if host_stop_fix:
            self._dev_stale = True
        if emitted is not None:
            self.spec_emitted += n_emitted
        self._count_tokens(n_emitted)
        for i in finished:
            info = self._slots[i]
            try:
                self._finalize(i)
            finally:
                info.req.out.put(STREAM_END)
        self.num_running = int(self._active.sum())

    def _finalize(self, slot: int, cause: str = "finalize") -> None:
        """Release a slot: its private pages go back (the ledger books them
        under ``cause``: ``finalize``, ``abort`` or ``salvage``), its cache
        refs are dropped, and the flight deck folds its record."""
        self.deck.on_finalize(slot)
        self._drop_decode_seat(slot)
        info = self._slots[slot]
        if info is not None:
            self._free_slot_pages(info.pages, cause)
            if self.prefix_cache is not None and info.cache_entries:
                self.prefix_cache.release(info.cache_entries)
        self._slots[slot] = None
        self._page_table[slot] = 0
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = self.pad_token_id
        self._n_generated[slot] = 0
        self._budgets[slot] = 0
        self._inflight_tok[slot] = 0
        if self._hist is not None:
            self._hist[slot] = None

    def _emit_abort(self, req: _Request) -> None:
        req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                     "finish_reason": "abort"})
        req.out.put(STREAM_END)

    def _emit_error(self, req: _Request, msg: str) -> None:
        req.out.put({"token_ids": [], "logprobs": [], "finished": True,
                     "finish_reason": "error", "error": msg})
        req.out.put(STREAM_END)

    def _fail_all(self, msg: str, finish_reason: str = "error") -> None:
        for i in np.flatnonzero(self._active):
            info = self._slots[i]
            self._active[i] = False
            try:
                self._finalize(i, cause="abort")
            finally:
                if info is not None:
                    if finish_reason == "abort":
                        self._emit_abort(info.req)
                    else:
                        self._emit_error(info.req, msg)
        self.num_running = 0

    def _count_tokens(self, n: int) -> None:
        self.total_tokens_served += n
        if n > 0:
            # the scheduler-side emission total of the deck's reconciliation
            self.deck.on_emitted(n)
        now = time.monotonic()
        self._tok_window.append((now, n))
        horizon = now - 10.0
        toks = sum(c for t, c in self._tok_window if t >= horizon)
        t_old = min((t for t, _ in self._tok_window if t >= horizon),
                    default=now)
        # a rate over a sub-0.2 s burst is meaningless: only update over a
        # meaningful span
        if now - t_old >= 0.2:
            self.last_gen_throughput = self._tput_ewma.update(
                toks / (now - t_old), now)

    # -- convenience (tests / bench) ----------------------------------------

    def generate(self, prompt_ids: list[list[int]], sampling: SamplingParams,
                 timeout: float = 300.0, rng=None) -> list[dict]:
        """Submit all, start the loop if needed, collect full sequences:
        per-prompt dicts with token_ids / logprobs / weight_versions /
        finish_reason. ``rng`` is accepted for interface parity and
        ignored, as in the JAX engine: the engine owns its sampling
        generator."""
        outs = [self.submit(f"gen-{i}", p, sampling)
                for i, p in enumerate(prompt_ids)]
        self.start()
        results = []
        deadline = time.monotonic() + timeout
        for out_q in outs:
            toks: list[int] = []
            lps: list[float] = []
            wvs: list[int] = []
            reason = "error"
            while True:
                item = out_q.get(timeout=max(0.0, deadline - time.monotonic()))
                if item is STREAM_END:
                    break
                toks.extend(item["token_ids"])
                lps.extend(item["logprobs"])
                wvs.extend([int(item.get("weight_version", -1))]
                           * len(item["token_ids"]))
                if item["finished"]:
                    reason = item["finish_reason"]
            results.append({"token_ids": toks, "logprobs": lps,
                            "weight_versions": wvs, "finish_reason": reason})
        return results
