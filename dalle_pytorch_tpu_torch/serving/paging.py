"""Host-side block-paged KV allocation + content-hash prefix caching.

Counterpart of the JAX package's `serving/paging.py` (host numpy there
too, copied here so the port imports nothing of that package). The
slotted continuous engine pins `max_batch * (total_seq_len + 1)` cache
positions on the device whether or not a row holds tokens. This module
is the host half of the paged layout; the device half is the paged slot
ops in `models/dalle.py`, the paged arm of `models/attention.py` and the
paged flash-decode kernels of `ops/flash_decode.py`:

  * `BlockPool` — refcounted physical-page allocator. Page 0 is RESERVED
    as the garbage page: released rows' page-table entries point at it, so
    a stale write (inactive rows compute along as padding in the chunk)
    can never corrupt a page that has been reallocated to another row.
  * `PrefixCache` — content-hash cache of immutable text-prefill pages.
    Chain hashes (hash of the token prefix through each FULL block) give
    longest-cached-prefix lookup: matched blocks are MAPPED into a new
    row's page table (refcount++, device-memory deduplication) instead of
    allocated; a FULL-prompt hit additionally carries a sidecar (pending
    logits + token-shift rings, device tensors) that lets admission skip
    the transformer prefill entirely (`models/dalle.py:
    admit_cached_prefix`). The divergence block (a text prefix rarely
    ends exactly on a page boundary) is copy-on-write: the cache keeps an
    immutable snapshot page, each hit gets a private copy to decode into.
    Eviction is LRU over entries whose pages the refcounts then settle:
    pages shared with live rows stay resident until those rows release.
  * `PagedKVManager` — per-row page tables + reservation accounting over
    the pool. Admission RESERVES a row's worst-case remaining pages
    (`pages_per_row - shared prefix blocks`) so lazy per-chunk allocation
    (`ensure`) can never deadlock mid-decode; `can_admit` counts
    cache-only pages as reclaimable (eviction on demand), so a full cache
    never blocks admission it could make room for.

Everything here is plain numpy/host state mutated only by the batcher's
single worker thread (same threading contract as `SlotAllocator`); the
device sees page tables only as [max_batch, pages_per_row] int32 tensors
uploaded per dispatch.
"""

from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

#: physical page 0 is never allocated; released/unmapped table entries
#: point here so stale fixed-shape writes land harmlessly
GARBAGE_PAGE = 0


class BlockPool:
    """Refcounted allocator over `n_pages` physical pages (page 0 reserved).

    `alloc` hands out the lowest free page (deterministic — same
    convention as `SlotAllocator`); `share` adds a reference to a live
    page (prefix blocks mapped into another row / retained by the cache);
    `release` drops one reference and returns the page to the free list
    at zero. Exhaustion returns None — callers decide whether to evict
    (prefix cache) or keep the request queued (admission).
    """

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "pool needs the garbage page plus >= 1 usable"
        self.n_pages = int(n_pages)
        # min-heap: ascending range is already heap-ordered
        self._free = list(range(1, self.n_pages))
        self._ref = np.zeros(self.n_pages, np.int32)
        self.peak_allocated = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def refcounts(self) -> Dict[int, int]:
        """{page: refcount} of every live page."""
        (live,) = np.nonzero(self._ref)
        return {int(p): int(self._ref[p]) for p in live}

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        page = heapq.heappop(self._free)
        self._ref[page] = 1
        self.peak_allocated = max(self.peak_allocated, self.n_allocated)
        return page

    def share(self, page: int) -> None:
        assert page != GARBAGE_PAGE and self._ref[page] >= 1, (
            f"page {page} is not live (ref {self._ref[page]})"
        )
        self._ref[page] += 1

    def release(self, page: int) -> None:
        assert page != GARBAGE_PAGE and self._ref[page] >= 1, (
            f"page {page} double-freed or never allocated"
        )
        self._ref[page] -= 1
        if self._ref[page] == 0:
            heapq.heappush(self._free, page)


def chain_hashes(text_ids: np.ndarray, page_size: int, n_blocks: int) -> List[str]:
    """Per-FULL-block chain hashes of a tokenized prompt.

    Block j of the prefill covers sequence positions [j*ps, (j+1)*ps);
    position 0 is the constant <bos>, so block j's K/V is a function of
    text ids [: (j+1)*ps - 1] exactly (causal attention, fixed rotary
    positions). Hash j therefore digests ids through that boundary —
    incremental, so the whole chain costs one pass over the prompt.
    """
    ids = np.ascontiguousarray(np.asarray(text_ids, np.int32))
    h = hashlib.sha1()
    out = []
    for j in range(n_blocks):
        lo = 0 if j == 0 else j * page_size - 1
        h.update(ids[lo : (j + 1) * page_size - 1].tobytes())
        out.append(h.hexdigest())
    return out


class _PrefixEntry:
    __slots__ = ("key", "chain", "full_pages", "partial_page", "sidecar")

    def __init__(self, key, chain, full_pages, partial_page, sidecar):
        self.key = key
        self.chain = chain  # chain hashes of the full blocks
        self.full_pages = full_pages  # immutable, shareable
        self.partial_page = partial_page  # CoW snapshot (None on boundary)
        self.sidecar = sidecar  # device tensors: pending logits + shift rings


class PrefixCache:
    """Content-hash prefix cache over pool pages; LRU eviction."""

    def __init__(
        self,
        pool: BlockPool,
        page_size: int,
        n_full_blocks: int,
        has_partial: bool,
        max_entries: int = 64,
    ):
        self.pool = pool
        self.page_size = int(page_size)
        self.n_full_blocks = int(n_full_blocks)
        self.has_partial = bool(has_partial)
        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        #: chain hash -> [page, n_entries referencing it]
        self._blocks: Dict[str, List[int]] = {}
        #: entry keys pinned against eviction for one admission wave: the
        #: batcher budgets a hit at `pages_per_row - saved` BEFORE the
        #: wave runs, so evicting the entry mid-wave (another row's
        #: allocation cascade) would demote the hit to a full prefill that
        #: consumes `saved` more pages than were charged — breaking the
        #: reservation invariant `_alloc_evicting` asserts on
        self._protected: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def enabled(self) -> bool:
        return self.max_entries > 0

    def _key(self, text_ids) -> bytes:
        return np.ascontiguousarray(np.asarray(text_ids, np.int32)).tobytes()

    def lookup_full(self, text_ids) -> Optional[_PrefixEntry]:
        """Whole-prompt hit (the zero-prefill-dispatch admission path);
        bumps LRU recency. Does NOT count hit/miss — the engine tallies
        per admission, not per probe."""
        entry = self._entries.get(self._key(text_ids))
        if entry is not None:
            self._entries.move_to_end(self._key(text_ids))
        return entry

    def peek_full(self, text_ids) -> Optional[_PrefixEntry]:
        """`lookup_full` without the LRU bump — for capacity probes: a
        queued-but-unadmittable prompt must not pin its entry against
        eviction by being asked about."""
        return self._entries.get(self._key(text_ids))

    def block_page(self, h: str) -> Optional[int]:
        """Page registered for one chain hash, None when unknown."""
        hit = self._blocks.get(h)
        return hit[0] if hit is not None else None

    def cache_only_pages(self) -> int:
        """Pages that would return to the pool if every entry were evicted
        right now (refcount 1 = the cache's own reference): the
        reclaimable headroom `can_admit` may count on."""
        n = 0
        for entry in self._entries.values():
            for page in entry.full_pages:
                if self.pool.refcount(page) == 1:
                    n += 1
            if entry.partial_page is not None and (
                self.pool.refcount(entry.partial_page) == 1
            ):
                n += 1
        return n

    def register(
        self,
        text_ids,
        full_pages: Sequence[int],
        partial_page: Optional[int],
        sidecar,
    ) -> None:
        """Adopt a freshly-prefilled prompt. The caller has already given
        the cache its references (pool.share on each full page; the
        partial snapshot page was allocated cache-owned). Evicts LRU
        entries past `max_entries`."""
        key = self._key(text_ids)
        assert key not in self._entries, "prompt already registered"
        chain = chain_hashes(text_ids, self.page_size, self.n_full_blocks)
        assert len(full_pages) == self.n_full_blocks
        for h, page in zip(chain, full_pages):
            ref = self._blocks.get(h)
            if ref is None:
                self._blocks[h] = [int(page), 1]
            else:
                assert ref[0] == int(page), (
                    "chain hash maps two different pages — caller must map "
                    "the cached page for matched prefix blocks"
                )
                ref[1] += 1
        self._entries[key] = _PrefixEntry(
            key, chain, [int(p) for p in full_pages], partial_page, sidecar
        )
        while len(self._entries) > self.max_entries:
            if not self.evict_lru():
                break  # everything protected: trim on the next wave

    def protect(self, keys) -> set:
        """Pin entries against eviction for the duration of one admission
        wave (the caller unprotects in a finally). Protected entries keep
        their LRU position; eviction simply skips them. Returns only the
        NEWLY protected keys so nested guards (the batcher pins a whole
        multi-split wave, `prefill_slots` pins its own split) unprotect
        exactly what they added."""
        added = set(keys) - self._protected
        self._protected.update(added)
        return added

    def unprotect(self, keys) -> None:
        self._protected.difference_update(keys)

    def evict_lru(self) -> bool:
        """Drop the least-recently-used unprotected entry; returns False
        when none is evictable. Pages shared with live rows stay allocated
        (refcount) — only the cache's own references are released."""
        victim = next((k for k in self._entries if k not in self._protected), None)
        if victim is None:
            return False
        entry = self._entries.pop(victim)
        for h, page in zip(entry.chain, entry.full_pages):
            ref = self._blocks[h]
            ref[1] -= 1
            if ref[1] == 0:
                del self._blocks[h]
            self.pool.release(page)
        if entry.partial_page is not None:
            self.pool.release(entry.partial_page)
        self.evictions += 1
        return True


class PagedKVManager:
    """Page tables + reservation accounting for the paged engine.

    One logical row per engine slot; `table` is the [n_rows,
    pages_per_row] int32 array every paged chunk uploads. Rows hold one
    pool reference per mapped page (shared prefix blocks included),
    released wholesale at `release(slot)`.
    """

    def __init__(
        self,
        n_rows: int,
        page_size: int,
        max_positions: int,
        text_positions: int,
        n_pages: int,
        max_entries: int = 64,
    ):
        self.page_size = int(page_size)
        self.max_positions = int(max_positions)  # total_seq_len + 1
        self.pages_per_row = -(-self.max_positions // self.page_size)
        self.text_positions = int(text_positions)  # text_seq_len + 1 (bos)
        self.n_text_pages = -(-self.text_positions // self.page_size)
        self.has_partial = self.text_positions % self.page_size != 0
        self.n_full_blocks = self.n_text_pages - 1 if self.has_partial else self.n_text_pages
        self.pool = BlockPool(n_pages)
        self.cache = PrefixCache(
            self.pool, self.page_size, self.n_full_blocks, self.has_partial,
            max_entries=max_entries,
        )
        self.n_rows = int(n_rows)
        self.table = np.zeros((self.n_rows, self.pages_per_row), np.int32)
        self._row_pages: List[List[int]] = [[] for _ in range(self.n_rows)]
        self._mapped = np.zeros(self.n_rows, np.int64)  # blocks mapped
        self._debt = np.zeros(self.n_rows, np.int64)  # pages still owed

    # --------------------------------------------------------- allocation

    def _alloc_evicting(self) -> int:
        """Allocate one page, evicting LRU prefix entries as needed. The
        reservation invariant guarantees success for reserved debt."""
        page = self.pool.alloc()
        while page is None:
            assert self.cache.evict_lru(), (
                "page pool exhausted with nothing evictable — reservation "
                "accounting is broken (admission must not have happened)"
            )
            page = self.pool.alloc()
        return page

    def _map(self, slot: int, block: int, page: int) -> None:
        """Record page in the row's table; the row's reference was already
        taken (alloc) or must be (share) by the caller."""
        self.table[slot, block] = page
        self._row_pages[slot].append(page)
        self._mapped[slot] = max(self._mapped[slot], block + 1)

    # ---------------------------------------------------------- admission

    def row_demand(self, text_ids) -> int:
        """Worst-case headroom this prompt consumes over its whole life.

        Only a FULL-entry hit reduces demand, and only by blocks some
        LIVE row already pins (pool refcount >= 2): mapping a cache-only
        page removes it from the reclaimable set `can_admit` counts on,
        which costs the same headroom an allocation would — and a
        partial-prefix match is charged the full worst case because the
        chain mappings it would splice can be deleted by another row's
        eviction cascade between budgeting and `admit_miss` (a full hit's
        entry is wave-protected against exactly that, a loose chain block
        is not). Under-counting either is how a reservation scheme
        deadlocks mid-decode."""
        if not self.cache.enabled:
            return self.pages_per_row
        entry = self.cache.peek_full(text_ids)
        if entry is None:
            return self.pages_per_row
        saved = sum(1 for p in entry.full_pages if self.pool.refcount(p) >= 2)
        return self.pages_per_row - saved

    def admission_headroom(self) -> int:
        """Pages available for NEW admissions: free + cache-reclaimable
        minus live rows' already-reserved debt. Fixed for the whole of one
        admission loop — pages move only at prefill/release, both on the
        batcher worker thread — so the batcher snapshots it once per wave
        and sums per-head `row_demand` against it."""
        available = self.pool.n_free + self.cache.cache_only_pages()
        return available - int(self._debt.sum())

    def can_admit(self, texts: Sequence[np.ndarray]) -> bool:
        """Free + cache-reclaimable pages cover the already-reserved debt
        of live rows PLUS this wave's worst case."""
        needed = sum(self.row_demand(ids) for ids in texts)
        return self.admission_headroom() >= needed

    def can_ever_admit(self, n_rows: int) -> bool:
        """Could a request of n_rows unique prompts EVER fit an empty
        pool? Submit-time rejection for requests that would queue
        forever."""
        return n_rows * self.pages_per_row <= self.pool.n_pages - 1

    def admit_miss(self, slot: int, text_ids, register: bool, pending_blocks=None):
        """Map/allocate the text-block pages for a prefill row. Returns
        (page_row [n_text_pages], partial_snapshot_page or GARBAGE_PAGE,
        shared_block_count, registration token or None).

        `pending_blocks` is a wave-local {chain hash: page} overlay for
        blocks earlier rows of the SAME admission wave mapped: two
        distinct prompts sharing a leading block must land on ONE page
        (the batched prefill writes every mapped page, and a page's
        content IS its chain hash no matter which row writes it), or
        their registrations would content-address the same hash to two
        different pages and trip `PrefixCache.register`'s invariant."""
        assert not self._row_pages[slot], f"slot {slot} already mapped"
        chain = (
            chain_hashes(text_ids, self.page_size, self.n_full_blocks)
            if self.cache.enabled
            else []
        )
        shared = []
        for h in chain:
            page = self.cache.block_page(h)
            if page is None and pending_blocks is not None:
                page = pending_blocks.get(h)
            if page is None:
                break
            shared.append(page)
        page_row = []
        for j, page in enumerate(shared):
            self.pool.share(page)  # the row's own reference
            self._map(slot, j, page)
            page_row.append(page)
        for j in range(len(shared), self.n_text_pages):
            page = self._alloc_evicting()
            self._map(slot, j, page)
            page_row.append(page)
        if pending_blocks is not None:
            for h, page in zip(chain, page_row):
                pending_blocks[h] = page
        self._debt[slot] = self.pages_per_row - self.n_text_pages
        partial_dst = GARBAGE_PAGE
        token = None
        register = register and self.cache.enabled and self.cache.lookup_full(text_ids) is None
        if register:
            # cache references on the full blocks now; the partial
            # snapshot page is cache-owned from birth. Registration pages
            # are reclaimable, so they never threaten the debt invariant —
            # but don't force an eviction just to register.
            partial_page = None
            if self.has_partial:
                partial_page = self.pool.alloc()
                if partial_page is None:
                    register = False
            if register:
                full_pages = page_row[: self.n_full_blocks]
                for page in full_pages:
                    self.pool.share(page)
                partial_dst = partial_page if partial_page is not None else GARBAGE_PAGE
                token = (text_ids, full_pages, partial_page)
        return page_row, partial_dst, len(shared), token

    def finish_register(self, token, sidecar) -> None:
        """Complete a registration begun in `admit_miss` once the prefill
        dispatch has produced the sidecar."""
        text_ids, full_pages, partial_page = token
        self.cache.register(text_ids, full_pages, partial_page, sidecar)

    def admit_hit(self, slot: int, entry: _PrefixEntry):
        """Map a full-prompt cache hit: share every full block, allocate
        the private copy-on-write page for the divergence block. Returns
        (partial_src, partial_dst) page ids for `admit_cached_prefix`
        (GARBAGE_PAGE when the prefix ends on a page boundary)."""
        assert not self._row_pages[slot], f"slot {slot} already mapped"
        for j, page in enumerate(entry.full_pages):
            self.pool.share(page)
            self._map(slot, j, page)
        partial_src = partial_dst = GARBAGE_PAGE
        if self.has_partial:
            partial_src = entry.partial_page
            partial_dst = self._alloc_evicting()
            self._map(slot, self.n_full_blocks, partial_dst)
        self._debt[slot] = self.pages_per_row - self.n_text_pages
        return partial_src, partial_dst

    def admit_resume(self, slot: int, n_positions: int) -> None:
        """Map fresh pages covering positions [0, n_positions) for a
        mid-decode resume row. No prefix sharing: the resume dispatch
        rewrites every page it maps with the row's own prompt + prefix
        K/V, which must never land on a page the prefix cache or another
        row maps; the row pays full pages, which is what the engine's
        `admission_demand` charged it. The other blocks stay on the
        garbage page until `ensure` maps them, covered by the row's
        reservation like any other debt."""
        assert not self._row_pages[slot], f"slot {slot} already mapped"
        n_blocks = min(-(-int(n_positions) // self.page_size), self.pages_per_row)
        for j in range(n_blocks):
            self._map(slot, j, self._alloc_evicting())
        self._debt[slot] = self.pages_per_row - n_blocks

    # ------------------------------------------------------- decode/release

    def ensure(self, slot: int, n_blocks: int) -> None:
        """Lazily allocate decode pages so the row's table covers its next
        chunk's writes (reserved at admission — cannot fail)."""
        n_blocks = min(int(n_blocks), self.pages_per_row)
        while self._mapped[slot] < n_blocks:
            page = self._alloc_evicting()
            self._map(slot, int(self._mapped[slot]), page)
            self._debt[slot] -= 1
        assert self._debt[slot] >= 0

    def release(self, slot: int) -> None:
        """Return the row's page references; table entries go back to the
        garbage page so the chunk's stale writes for this slot can never
        touch live pages."""
        for page in self._row_pages[slot]:
            self.pool.release(page)
        self._row_pages[slot] = []
        self.table[slot, :] = GARBAGE_PAGE
        self._mapped[slot] = 0
        self._debt[slot] = 0

    @property
    def blocks_active(self) -> int:
        return self.pool.n_allocated

    @property
    def blocks_free(self) -> int:
        return self.pool.n_free

    def leak_check(self) -> List[str]:
        """Audit the reservation/refcount invariants; returns violation
        strings (empty = consistent)."""
        problems: List[str] = []
        expected: Dict[int, int] = {}
        for slot, pages in enumerate(self._row_pages):
            for p in pages:
                expected[p] = expected.get(p, 0) + 1
            mapped, debt = int(self._mapped[slot]), int(self._debt[slot])
            if pages and mapped + debt != self.pages_per_row:
                problems.append(
                    f"slot {slot}: mapped {mapped} + reserved {debt} != "
                    f"pages_per_row {self.pages_per_row}"
                )
            if not pages and (mapped or debt):
                problems.append(f"slot {slot}: no pages but mapped={mapped} debt={debt}")
            live = [int(p) for p in self.table[slot] if p != GARBAGE_PAGE]
            if sorted(live) != sorted(pages):
                problems.append(
                    f"slot {slot}: table pages {sorted(live)} != row pages {sorted(pages)}"
                )
        for entry in self.cache._entries.values():
            for p in entry.full_pages:
                expected[p] = expected.get(p, 0) + 1
            if entry.partial_page is not None:
                expected[entry.partial_page] = expected.get(entry.partial_page, 0) + 1
        actual = self.pool.refcounts()
        for p in sorted(set(expected) | set(actual)):
            if expected.get(p, 0) != actual.get(p, 0):
                problems.append(
                    f"page {p}: refcount {actual.get(p, 0)} but "
                    f"{expected.get(p, 0)} references held (rows + cache)"
                )
        free = sorted(self.pool._free)
        should_be_free = sorted(p for p in range(1, self.pool.n_pages) if p not in actual)
        if free != should_be_free:
            problems.append(f"free list {free} != unreferenced pages {should_be_free}")
        return problems

    def debug_dump(self) -> Dict:
        """JSON-ready paging state for stall reports and the engine's
        `state_dump`: per-row pages and reservations, live-page refcounts,
        prefix-cache counts. Plain host reads of the worker-owned
        structures: a point-in-time view."""
        rows = [
            {
                "slot": slot,
                "pages": [int(p) for p in pages],
                "blocks_mapped": int(self._mapped[slot]),
                "pages_reserved": int(self._debt[slot]),
            }
            for slot, pages in enumerate(self._row_pages)
            if pages or self._debt[slot]
        ]
        return {
            "page_size": self.page_size,
            "pages_per_row": self.pages_per_row,
            "blocks_total": self.pool.n_pages - 1,
            "blocks_active": self.blocks_active,
            "blocks_free": self.blocks_free,
            "page_refcounts": self.pool.refcounts(),
            "rows": rows,
            "prefix_cache": {
                "entries": len(self.cache),
                "protected": len(self.cache._protected),
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "evictions": self.cache.evictions,
            },
        }
