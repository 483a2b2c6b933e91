"""Page-granular prefix cache for the continuous-batching engine.

The port's own copy of ``polyrl_tpu/rollout/prefix_cache.py`` (the port
imports nothing of the JAX package), without the host-RAM spill hooks and
the ledger's cold-first eviction order, which belong to later slices.

Completed full pages of prompt KV are published under a chained
page-content hash; later admissions reuse the longest matched run of pages
and prefill only the suffix. Pages are shared read-only with refcounts;
unreferenced entries stay resident and are LRU-evicted back to the page
allocator under pool pressure. GRPO's n-samples-per-prompt makes the hit
rate structural: the first sample prefills, the other n-1 reuse every full
prompt page.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class _Entry:
    key: tuple
    page: int
    refcount: int = 0
    tick: int = 0
    orphaned: bool = False  # dropped from the map while still referenced
    # collision guard: the hash key alone is not trusted. Each entry
    # records its page's tokens and the identity of its parent entry; a
    # match requires token equality at every page AND that the parent
    # chain is the exact sequence of entries already verified.
    page_toks: tuple = ()
    parent: "_Entry | None" = None


class PrefixCache:
    def __init__(self, page_size: int, free_pages: Callable[[list[int]], None]):
        self.page_size = page_size
        self._free_pages = free_pages
        self._map: dict[tuple, _Entry] = {}
        self._tick = 0
        self.hits = 0       # pages served from cache
        self.misses = 0     # full pages prefilled fresh
        self.evictions = {"capacity": 0, "flush": 0, "preref_ttl": 0}
        self.req_hits = 0
        self.req_misses = 0

    def _free(self, pages: list[int], cause: str) -> None:
        self.evictions[cause] = self.evictions.get(cause, 0) + len(pages)
        self._free_pages(pages)

    # -- keys ---------------------------------------------------------------

    def _keys_for(self, tokens: list[int], n_pages: int) -> list[tuple]:
        keys = []
        parent: tuple = ()
        for i in range(n_pages):
            page_toks = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            parent = (hash((parent, page_toks)),)
            keys.append(parent)
        return keys

    # -- lookup / publish ----------------------------------------------------

    def match(self, tokens: list[int]) -> tuple[list[int], list[_Entry]]:
        """Longest run of cached full pages for this prompt, holding a ref on
        each. At least one token is always left for the suffix (the prefill
        must produce last-token logits)."""
        n_full = max(0, (len(tokens) - 1) // self.page_size)
        pages: list[int] = []
        entries: list[_Entry] = []
        self._tick += 1
        prev: _Entry | None = None
        for i, key in enumerate(self._keys_for(tokens, n_full)):
            e = self._map.get(key)
            page_toks = tuple(
                tokens[i * self.page_size:(i + 1) * self.page_size])
            if e is None or e.page_toks != page_toks or e.parent is not prev:
                break
            e.refcount += 1
            e.tick = self._tick
            pages.append(e.page)
            entries.append(e)
            prev = e
        self.hits += len(pages)
        return pages, entries

    def publish(self, tokens: list[int], page_ids: list[int],
                n_cached: int,
                matched_entries: "list[_Entry] | None" = None
                ) -> list[tuple[int, _Entry]]:
        """Register the freshly prefilled full pages ``page_ids[n_cached:]``
        (ownership moves to the cache; caller keeps a ref). Returns
        ``(prompt_page_index, entry)`` for each page actually published —
        pages whose key already exists stay caller-owned. ``matched_entries``
        is the chain ``match()`` verified; the parent is taken from it, not
        resolved by key."""
        n_full = max(0, (len(tokens) - 1) // self.page_size)
        keys = self._keys_for(tokens, n_full)
        out: list[tuple[int, _Entry]] = []
        self._tick += 1
        if n_cached > 0:
            if not matched_entries or len(matched_entries) < n_cached:
                raise ValueError("publish with n_cached > 0 requires the "
                                 "match() entry list")
            prev: _Entry | None = matched_entries[n_cached - 1]
        else:
            prev = None
        for i in range(n_cached, n_full):
            key = keys[i]
            page_toks = tuple(
                tokens[i * self.page_size:(i + 1) * self.page_size])
            existing = self._map.get(key)
            if existing is not None:
                # duplicate key: caller's page stays slot-private; keep
                # chaining only if the existing entry really is this prefix
                if existing.page_toks == page_toks and existing.parent is prev:
                    prev = existing
                    continue
                if existing.refcount == 0:
                    # stale squatter (child of an evicted parent, or a
                    # colliding entry): replace it
                    del self._map[key]
                    self._free([existing.page], "capacity")
                    e = _Entry(key=key, page=page_ids[i], refcount=1,
                               tick=self._tick, page_toks=page_toks,
                               parent=prev)
                    self._map[key] = e
                    out.append((i, e))
                    prev = e
                    continue
                break
            e = _Entry(key=key, page=page_ids[i], refcount=1, tick=self._tick,
                       page_toks=page_toks, parent=prev)
            self._map[key] = e
            out.append((i, e))
            prev = e
        self.misses += max(0, n_full - n_cached)
        return out

    def note_request(self, hit: bool) -> None:
        if hit:
            self.req_hits += 1
        else:
            self.req_misses += 1

    # -- refs ----------------------------------------------------------------

    def retain(self, entries: list[_Entry], n: int = 1) -> None:
        """Take ``n`` extra refs on each entry (group pre-refs)."""
        if n <= 0:
            return
        for e in entries:
            e.refcount += n

    def release(self, entries: list[_Entry], cause: str = "flush") -> None:
        """Drop one ref per entry; orphaned entries (flushed while
        referenced) free their page at refcount 0."""
        freed: list[int] = []
        for e in entries:
            e.refcount -= 1
            if e.refcount == 0 and e.orphaned:
                freed.append(e.page)
        if freed:
            self._free(freed, cause)

    # -- eviction / flush ----------------------------------------------------

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` unreferenced pages, least recently used
        first. Returns how many pages were freed."""
        candidates = [e for e in self._map.values() if e.refcount == 0]
        victims = sorted(candidates, key=lambda e: e.tick)[:n_pages]
        if not victims:
            return 0
        for e in victims:
            del self._map[e.key]
        self._free([e.page for e in victims], "capacity")
        return len(victims)

    def flush(self) -> None:
        """Invalidate everything (weight update): unreferenced pages return
        to the allocator now; referenced ones are orphaned and freed when
        their last holder releases."""
        freed: list[int] = []
        for e in self._map.values():
            if e.refcount == 0:
                freed.append(e.page)
            else:
                e.orphaned = True
        self._map.clear()
        if freed:
            self._free(freed, "flush")

    @property
    def request_hit_frac(self) -> float:
        total = self.req_hits + self.req_misses
        return self.req_hits / total if total else 0.0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"prefix_cache/entries": float(len(self._map)),
                "prefix_cache/hit_pages": float(self.hits),
                "prefix_cache/hit_rate": self.hits / total if total else 0.0,
                "prefix_cache/req_hits": float(self.req_hits),
                "prefix_cache/req_misses": float(self.req_misses),
                "prefix_cache/req_hit_frac": self.request_hit_frac,
                "prefix_cache/evict_capacity": float(self.evictions["capacity"]),
                "prefix_cache/evict_flush": float(self.evictions["flush"]),
                "prefix_cache/evict_preref_ttl": float(
                    self.evictions["preref_ttl"])}
