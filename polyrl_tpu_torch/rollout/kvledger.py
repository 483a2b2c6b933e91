"""Per-page KV ledger: the engine's memory plane.

The port's own copy of ``polyrl_tpu/rollout/kvledger.py``, with
:func:`hbm_truth` read from ``torch.cuda``. One record per physical page,
kept synchronously on the engine loop thread at every page transition:

- **role** -- ``free`` / ``active_decode`` (slot-owned) /
  ``prefix_cache_published`` (cache-owned, refcounted) /
  ``group_preref_held`` (published and pinned by group-shared prefill
  pre-refs) / ``spilled`` (a logical role: the content lives in the host
  spill tier, ``rollout/kvspill.py``, while the physical page is back on
  the free list); page 0 is the reserved null page and stays out of every
  count.
- **owner** -- the rid (or group id) the page was allocated for.
- **birth / last-touch dispatch** -- decode-dispatch ticks; each dispatch
  touches every page of every active slot's page row, so idle age = ticks
  since a decode last read the page.
- **free cause** -- ``finalize`` / ``abort`` / ``salvage`` /
  ``cache_pressure`` / ``flush`` / ``preref_ttl``; page lifetime (free -
  birth) and idle-at-free age feed log2 histograms.

**Residency tiers**: a per-dispatch sweep buckets resident pages by idle
age: hot (< cold_after/4 dispatches), warm (< cold_after), cold (>=
cold_after, ``rollout.kv_cold_after_dispatches``). The cold set is the
spill tier's candidate set.

**Reconciliation**: the ledger's role counts must match the allocator free
list plus the prefix cache's entries (resident and spilled) exactly
whenever the engine is quiescent; ``memory/attributed_frac`` < 1.0 is
transient mid-churn, and a persistent deficit is a leak with a number.

**HBM truth** (:func:`hbm_truth`): the card's allocated and free bytes
against the bytes the ledger accounts for (KV pools and weights).

Thread-safety: mutators run on the engine loop thread; readers
(``server_info`` handler threads) take the same lock.
"""

from __future__ import annotations

import threading

import numpy as np

import torch

from polyrl_tpu_torch.obs.histogram import Histogram

ROLE_FREE = 0
ROLE_ACTIVE = 1
ROLE_PUBLISHED = 2
ROLE_PREREF = 3
ROLE_RESERVED = 4  # page 0: the null page — never allocated, never counted

ROLE_NAMES = ("free", "active_decode", "prefix_cache_published",
              "group_preref_held")

# the "spilled" role is LOGICAL, not physical: a spilled page's content
# lives in host RAM (rollout/kvspill.py) while its physical page is back
# on the allocator free list — so it is tracked as a scalar count beside
# the physical role array, and role_counts() reports it as a fifth role

FREE_CAUSES = ("finalize", "abort", "salvage", "cache_pressure", "flush",
               "preref_ttl")

_GB = 1e9


def hbm_truth(accounted_bytes: float, device=None) -> dict:
    """Device-memory reconciliation on a CUDA ``device``: ``hbm_used_gb``
    is ``torch.cuda.memory_allocated`` (this process's tensors),
    ``hbm_headroom_gb`` the device's free memory from
    ``torch.cuda.mem_get_info``, which covers every process on the card (a
    trainer and a rollout server sharing one card both count against it),
    and ``hbm_unaccounted_gb`` what this process holds beyond the bytes the
    ledger can attribute (KV pools and weights). Neither call waits for the
    engine's stream. ``{}`` for a CPU device or none: callers treat the keys
    as optional."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    used = float(torch.cuda.memory_allocated(device))
    free, _total = torch.cuda.mem_get_info(device)
    return {
        "hbm_used_gb": used / _GB,
        # what this process allocated beyond the pools and the weights
        # (activations, graph pools, staging, a leak): a number to watch
        # instead of a surprise OOM
        "hbm_unaccounted_gb": max(0.0, used - float(accounted_bytes)) / _GB,
        "hbm_headroom_gb": float(free) / _GB,
    }


class PageLedger:
    """One record per physical KV page; see the module docstring. All
    page-id arguments are iterables of ints from the engine's allocator
    domain (1..num_pages-1). ``device`` is the engine's (for
    :func:`hbm_truth`)."""

    def __init__(self, num_pages: int, page_size: int,
                 cold_after_dispatches: int = 256, device=None):
        self.num_pages = int(num_pages)
        self.device = device  # whose memory hbm_truth reads
        self.num_alloc_pages = self.num_pages - 1
        self.page_size = int(page_size)
        self.cold_after = max(1, int(cold_after_dispatches))
        self.warm_after = max(1, self.cold_after // 4)
        # per-page KV bytes; set by the engine once pools materialize
        self.page_bytes = 0
        self._lock = threading.Lock()
        self._role = np.zeros((self.num_pages,), np.uint8)
        self._role[0] = ROLE_RESERVED
        self._birth = np.zeros((self.num_pages,), np.int64)
        self._touch = np.zeros((self.num_pages,), np.int64)
        self._owner: list[str] = [""] * self.num_pages
        self.dispatch = 0  # monotone decode-dispatch tick
        # churn counters (cumulative)
        self.page_allocs = 0
        self.page_frees = 0
        self.page_publishes = 0
        self.freed_by_cause = {c: 0 for c in FREE_CAUSES}
        self.hists = {
            "page_lifetime_dispatches": Histogram(),  # free − birth
            "page_idle_age_dispatches": Histogram(),  # free − last touch
        }
        # last sweep (scalars; served without re-sweeping)
        self._tier_pages = {"hot": 0, "warm": 0, "cold": 0}
        # host-RAM spill tier (rollout/kvspill.py): page-count/byte truth.
        # spilled_pages is the CURRENT logical-spilled count (the "spilled"
        # role); the rest are cumulative. Reconciliation stays exact:
        # HBM-resident cache pages + spilled == prefix-cache entries.
        self.spilled_pages = 0
        self.pages_spilled = 0   # cumulative device→host
        self.pages_restored = 0  # cumulative host→device
        self.spill_drops = 0     # spilled content freed without restore
        self.spill_bytes = 0     # cumulative bytes device→host
        self.restore_bytes = 0   # cumulative bytes host→device
        # restore rate (pages/dispatch over a short window): the
        # spill-thrash signal; a HIGH rate means restores chase the sweep
        # (watermark hysteresis defeated)
        self.restore_rate = 0.0
        self._restore_marks: list[tuple[int, int]] = []

    # -- transitions (engine loop thread) ------------------------------------

    def on_alloc(self, pages, owner: str = "") -> None:
        """Pages left the allocator free list for a slot (active-decode)."""
        if not len(pages):
            return
        idx = np.asarray(pages, np.int64)
        with self._lock:
            self._role[idx] = ROLE_ACTIVE
            self._birth[idx] = self.dispatch
            self._touch[idx] = self.dispatch
            for p in idx.tolist():
                self._owner[p] = owner
            self.page_allocs += len(idx)

    def on_publish(self, pages) -> None:
        """Ownership moved slot → prefix cache (publish); only pages the
        ledger holds as active transition (a re-publish of an already
        cached page is a no-op, matching the cache's dedup)."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            sel = idx[self._role[idx] == ROLE_ACTIVE]
            self._role[sel] = ROLE_PUBLISHED
            self.page_publishes += len(sel)

    def on_preref_hold(self, pages) -> None:
        """Group-shared prefill pre-refs pinned these published pages."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            sel = idx[self._role[idx] == ROLE_PUBLISHED]
            self._role[sel] = ROLE_PREREF

    def on_preref_release(self, pages) -> None:
        """The group's pre-refs are gone (consumed / TTL-swept /
        disbanded): pinned pages fall back to plain published. Pages a
        release already freed (flush orphans) stay free — the guard on the
        current role makes the two orderings commute."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            sel = idx[self._role[idx] == ROLE_PREREF]
            self._role[sel] = ROLE_PUBLISHED

    def on_free(self, pages, cause: str) -> None:
        """Pages returned to the allocator free list; ``cause`` is one of
        :data:`FREE_CAUSES`."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            idx = idx[self._role[idx] != ROLE_FREE]  # double-free guard
            if not len(idx):
                return
            tick = self.dispatch
            self.hists["page_lifetime_dispatches"].observe_many(
                tick - self._birth[idx])
            self.hists["page_idle_age_dispatches"].observe_many(
                tick - self._touch[idx])
            self._role[idx] = ROLE_FREE
            for p in idx.tolist():
                self._owner[p] = ""
            n = len(idx)
            self.page_frees += n
            self.freed_by_cause[cause] = self.freed_by_cause.get(cause, 0) + n

    def on_spill(self, pages) -> None:
        """Published pages left HBM for the host spill tier: the physical
        pages are FREE again (the engine hands them to the allocator), the
        content moves to the logical ``spilled`` role. Not a free-cause —
        the KV survives, so lifetime/idle histograms stay untouched."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            sel = idx[self._role[idx] == ROLE_PUBLISHED]
            self._role[sel] = ROLE_FREE
            for p in sel.tolist():
                self._owner[p] = ""
            n = len(sel)
            self.spilled_pages += n
            self.pages_spilled += n
            self.spill_bytes += n * self.page_bytes

    def on_restore(self, pages) -> None:
        """Spilled content landed back in HBM at freshly allocated pages:
        they are cache-owned (published) immediately — a restore only ever
        happens for a prefix hit or a resuming chain about to attach."""
        if not len(pages):
            return
        idx = np.asarray(list(pages), np.int64)
        with self._lock:
            sel = idx[self._role[idx] == ROLE_FREE]
            self._role[sel] = ROLE_PUBLISHED
            self._birth[sel] = self.dispatch
            self._touch[sel] = self.dispatch
            n = len(sel)
            self.spilled_pages = max(0, self.spilled_pages - n)
            self.pages_restored += n
            self.restore_bytes += n * self.page_bytes

    def on_spill_drop(self, n: int) -> None:
        """Spilled content died without a restore (abort while spilled,
        cache flush, weight swap): both tiers are now free."""
        with self._lock:
            n = int(n)
            self.spilled_pages = max(0, self.spilled_pages - n)
            self.spill_drops += n

    def idle_age(self, page: int) -> int:
        """Dispatches since a decode last touched this resident page (the
        prefix cache's cold-first eviction order and the spill sweep's
        candidate ranking both key on it)."""
        with self._lock:
            return int(self.dispatch - self._touch[int(page)])

    def is_cold(self, page: int) -> bool:
        return self.idle_age(page) >= self.cold_after

    def on_dispatch(self, touched) -> None:
        """One decode dispatch: advance the tick, touch the pages the
        dispatch attends (every active slot's page row), and re-sweep the
        residency tiers. ``touched`` is an int array of page ids (page 0
        padding is tolerated — the reserved role keeps it out of every
        count)."""
        idx = np.asarray(touched, np.int64)
        with self._lock:
            self.dispatch += 1
            if len(idx):
                self._touch[idx] = self.dispatch
            resident = (self._role == ROLE_ACTIVE) \
                | (self._role == ROLE_PUBLISHED) \
                | (self._role == ROLE_PREREF)
            idle = self.dispatch - self._touch[resident]
            self._tier_pages = {
                "hot": int((idle < self.warm_after).sum()),
                "warm": int(((idle >= self.warm_after)
                             & (idle < self.cold_after)).sum()),
                "cold": int((idle >= self.cold_after).sum()),
            }
            # restore rate over the last ≤64 dispatches (pages/dispatch)
            self._restore_marks.append((self.dispatch, self.pages_restored))
            if len(self._restore_marks) > 64:
                self._restore_marks.pop(0)
            t0, r0 = self._restore_marks[0]
            span = self.dispatch - t0
            self.restore_rate = ((self.pages_restored - r0) / span
                                 if span > 0 else 0.0)

    # -- views ----------------------------------------------------------------

    def role_counts(self) -> dict[str, int]:
        with self._lock:
            return self._role_counts_locked()

    def _role_counts_locked(self) -> dict[str, int]:
        counts = np.bincount(self._role, minlength=5)
        out = {name: int(counts[i]) for i, name in enumerate(ROLE_NAMES)}
        # the logical fifth role: content in host RAM, physical page free
        out["spilled"] = int(self.spilled_pages)
        return out

    def attributed_frac(self, pool_free: int, cache_pages: int) -> float:
        """1.0 exactly when the ledger's role counts match the pool truth:
        ledger-free == allocator free-list length AND ledger cache-resident
        (published + preref-held) == prefix-cache entries. Transiently < 1
        mid-churn (flush orphans pending release); persistently < 1 = a
        missed transition = a leak with a number."""
        with self._lock:
            return self._attributed_locked(pool_free, cache_pages)

    def _attributed_locked(self, pool_free: int, cache_pages: int) -> float:
        c = self._role_counts_locked()
        # cache entries split across two tiers: HBM-resident (published /
        # preref-held physical pages) + spilled (content in host RAM) must
        # cover the prefix cache's entry count exactly
        mismatch = (abs(c["free"] - int(pool_free))
                    + abs(c["prefix_cache_published"]
                          + c["group_preref_held"] + c["spilled"]
                          - int(cache_pages)))
        return max(0.0, 1.0 - mismatch / max(1, self.num_alloc_pages))

    def server_info_fields(self, pool_free: int, cache_pages: int,
                           accounted_bytes: float) -> dict:
        """Flat fields merged into ``server_info`` (the manager's stats
        poller forwards ``kv_cold_page_frac`` / ``hbm_headroom_gb`` per
        instance)."""
        with self._lock:
            n = max(1, self.num_alloc_pages)
            tiers = dict(self._tier_pages)
            fields = {
                "kv_hot_page_frac": round(tiers["hot"] / n, 6),
                "kv_warm_page_frac": round(tiers["warm"] / n, 6),
                "kv_cold_page_frac": round(tiers["cold"] / n, 6),
                "kv_cold_bytes": float(tiers["cold"] * self.page_bytes),
                # host-RAM spill tier (the manager forwards both per
                # instance; spilled_frac is relative to the HBM pool —
                # >1.0 legitimately means MORE KV lives on host than fits
                # on chip, the oversubscription win itself)
                "kv_spilled_frac": round(self.spilled_pages / n, 6),
                "kv_restore_rate": round(self.restore_rate, 6),
                "memory/attributed_frac": round(
                    self._attributed_locked(pool_free, cache_pages), 6),
                "memory/page_allocs": float(self.page_allocs),
                "memory/page_frees": float(self.page_frees),
                "memory/page_publishes": float(self.page_publishes),
                "memory/spilled_pages": float(self.spilled_pages),
                "memory/pages_spilled": float(self.pages_spilled),
                "memory/pages_restored": float(self.pages_restored),
                "memory/spill_drops": float(self.spill_drops),
                "memory/spill_bytes": float(self.spill_bytes),
                "memory/restore_bytes": float(self.restore_bytes),
            }
            for cause, count in self.freed_by_cause.items():
                fields[f"memory/freed_{cause}"] = float(count)
        fields.update(hbm_truth(accounted_bytes, self.device))
        return fields

    def snapshot(self, pool_free: int, cache_pages: int,
                 accounted_bytes: float) -> dict:
        """The nested ``memory`` view (the ``/statusz`` ``memory``
        section)."""
        with self._lock:
            counts = self._role_counts_locked()
            owners: dict[str, int] = {}
            for p in range(1, self.num_pages):
                if self._role[p] in (ROLE_ACTIVE, ROLE_PREREF) \
                        and self._owner[p]:
                    owners[self._owner[p]] = owners.get(self._owner[p], 0) + 1
            top_owners = dict(sorted(owners.items(),
                                     key=lambda kv: -kv[1])[:8])
            out = {
                "roles": counts,
                "tiers": {
                    **{k: int(v) for k, v in self._tier_pages.items()},
                    "cold_bytes": float(self._tier_pages["cold"]
                                        * self.page_bytes),
                    "warm_after_dispatches": self.warm_after,
                    "cold_after_dispatches": self.cold_after,
                },
                "churn": {
                    "page_allocs": self.page_allocs,
                    "page_frees": self.page_frees,
                    "page_publishes": self.page_publishes,
                    "freed_by_cause": dict(self.freed_by_cause),
                },
                "reconcile": {
                    "attributed_frac": round(self._attributed_locked(
                        pool_free, cache_pages), 6),
                    "ledger_free": counts["free"],
                    "pool_free": int(pool_free),
                    # HBM-resident cache pages + spilled == cache entries
                    "ledger_cache": counts["prefix_cache_published"]
                    + counts["group_preref_held"] + counts["spilled"],
                    "cache_pages": int(cache_pages),
                },
                "spill": {
                    "spilled_pages": int(self.spilled_pages),
                    "spilled_bytes": int(self.spilled_pages
                                         * self.page_bytes),
                    "pages_spilled": int(self.pages_spilled),
                    "pages_restored": int(self.pages_restored),
                    "spill_drops": int(self.spill_drops),
                    "spill_bytes": int(self.spill_bytes),
                    "restore_bytes": int(self.restore_bytes),
                    "restore_rate": round(self.restore_rate, 6),
                },
                "hists": {name: {"p50": h.percentile(50.0),
                                 "p95": h.percentile(95.0),
                                 "p99": h.percentile(99.0),
                                 "max": h.vmax, "mean": h.mean,
                                 "count": h.count}
                          for name, h in self.hists.items() if h.count},
                "top_owners": top_owners,
                "dispatch": self.dispatch,
                "page_bytes": int(self.page_bytes),
                "accounted_bytes": float(accounted_bytes),
            }
        out["hbm"] = hbm_truth(accounted_bytes, self.device)
        return out
