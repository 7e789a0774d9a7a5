"""Host-side page-pool accounting for the paged decode cache
(``repro/serve/paging.py``).

The device side of the paged layout lives in ``models/attention.py``
(:class:`PagedKVCache`: per-layer page pools + per-slot block tables) and
``kernels/flash_decode.py`` (K7/K8, decode through the block table). This
module is the *allocator*: plain-numpy free-list bookkeeping the engine
consults before admission -- no torch, no device work, so an admission
decision costs nothing on the card.

One :class:`PageAllocator` per pool (= per attention cache group in the
stage tree; all layers of a stacked group share one block table, so one
allocator covers the whole stack). Pages are *refcounted*: a page may
appear in several owners' rows at once (copy-on-write prefix sharing —
``allocate`` can adopt the full-page prefix of an existing owner's row),
``release`` decrements and only returns a page to the free list when its
last reference drops. Eviction touches no device memory — a freed page's
stale K/V rows are unreachable because no live block table maps them,
and ``page_pos`` is reset to -1 when the page is handed to its next
owner (serve/cache.write_slot_paged).

Owners are any hashable key: engine slots use their int slot id, and the
engine's prefix index retains a retired request's prompt pages under a
``("prefix", uid)`` key so future requests can keep adopting them.

Reserved vs used: ``reserved`` counts pages handed out (the admission
currency), ``used`` counts tokens actually written (what a dense layout
would have needed). The gap between the dense worst case and ``reserved``
is the paged win; engine.stats() surfaces both via
core.stats.serving_cache_metrics.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Static shape facts of one page pool (derived from its cache node)."""

    page_size: int        # tokens per page
    n_pages: int          # physical pages in the pool
    blocks_per_slot: int  # block-table width nb (logical blocks per slot)
    ring: bool            # sliding-window ring: logical positions wrap
    token_bytes: int      # K+V bytes per cached token across the layer stack

    @property
    def logical_size(self) -> int:
        """Per-slot logical cache size (the dense S rounded up to pages)."""
        return self.blocks_per_slot * self.page_size

    @property
    def page_bytes(self) -> int:
        return self.page_size * self.token_bytes


def spec_from_cache(node, token_bytes: int) -> PoolSpec:
    """PoolSpec for a layer-stacked paged node: pools (layers, n_pages,
    page_size, KV, w), block_table (layers, B, nb). ``token_bytes`` comes
    from the caller (serve/cache.kv_token_bytes -- one formula for the
    allocator and the engine's accounting, and this module stays
    numpy-only). A per-replica sharded node (pools (layers, dp, n_pages/dp,
    ...), block_table (layers, dp, B/dp, nb)) yields the spec of one
    shard: ``n_pages`` is one replica's page budget, matching the
    allocator per pool and shard the engine keeps, whose page ids are
    shard-local."""
    lead = 2 if node.sharded else 1
    return PoolSpec(
        page_size=node.k_pages.shape[lead + 1],
        n_pages=node.k_pages.shape[lead],
        blocks_per_slot=node.block_table.shape[lead + 1],
        ring=bool(node.ring),
        token_bytes=token_bytes,
    )


class PageAllocator:
    """Free-list allocator over one pool. Host-side only.

    The engine's admission predicate is ``can_allocate(blocks_for(...))``
    for every pool; ``allocate`` returns the slot's block-table row ready
    to install on device, ``append`` grows a live slot's table (lazy
    reservation), ``release`` reclaims on eviction.
    """

    def __init__(self, spec: PoolSpec):
        self.spec = spec
        # LIFO free list: recently freed pages are reused first, which
        # keeps the working set hot and makes leak bugs loud in tests.
        self._free: list[int] = list(range(spec.n_pages - 1, -1, -1))
        self._owned: dict[object, np.ndarray] = {}
        # per-page reference count: 0 = free, 1 = exclusive, > 1 = shared
        self._ref = np.zeros((spec.n_pages,), np.int64)
        # lifetime counter: > n_pages proves pages cycle through owners
        self.total_page_allocations = 0

    # -- accounting ----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self.spec.n_pages - len(self._free)

    @property
    def reserved_bytes(self) -> int:
        return self.reserved_pages * self.spec.page_bytes

    def used_tokens(self, pos: int) -> int:
        """Tokens live in this pool for a slot whose next decode position
        is ``pos`` (= tokens written so far; ring slots cap at the logical
        size since older entries have been overwritten)."""
        return min(max(int(pos), 0), self.spec.logical_size)

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced by more than one owner."""
        return int(np.sum(self._ref > 1))

    def page_ref(self, page: int) -> int:
        return int(self._ref[page])

    def check_invariant(self) -> None:
        """Refcount conservation (churn-test hook): every page's refcount
        equals the number of owner rows that map it, the free list holds
        exactly the zero-ref pages, and no page is free twice."""
        counts = np.zeros((self.spec.n_pages,), np.int64)
        for row in self._owned.values():
            for p in row:
                if p >= 0:
                    counts[int(p)] += 1
        if not np.array_equal(counts, self._ref):
            bad = np.nonzero(counts != self._ref)[0][:8]
            raise AssertionError(
                f"page pool corrupt: refcounts {self._ref[bad].tolist()} != "
                f"owner-row counts {counts[bad].tolist()} at pages "
                f"{bad.tolist()}")
        if len(self._free) != len(set(self._free)):
            raise AssertionError("page pool corrupt: duplicate free pages")
        free = np.zeros((self.spec.n_pages,), bool)
        free[self._free] = True
        if not np.array_equal(free, self._ref == 0):
            raise AssertionError(
                f"page pool corrupt: {len(self._free)} free pages do not "
                f"match the {int(np.sum(self._ref == 0))} zero-ref pages")

    # -- sizing --------------------------------------------------------
    def blocks_for(self, total_tokens: int) -> int:
        """Blocks a request storing ``total_tokens`` needs (prompt +
        worst-case generation). Ring pools cap at the bounded table width
        — a sliding window never needs more than the window's worth of
        pages, older positions overwrite in place. A non-ring request
        exceeding the logical slot size is a sizing bug and raises rather
        than silently under-reserving."""
        need = -(-total_tokens // self.spec.page_size)
        if need > self.spec.blocks_per_slot:
            if self.spec.ring:
                return self.spec.blocks_per_slot
            raise ValueError(
                f"request of {total_tokens} tokens needs {need} pages but "
                f"the non-ring slot table holds {self.spec.blocks_per_slot} "
                f"(logical size {self.spec.logical_size} tokens)")
        return need

    def can_allocate(self, n_blocks: int) -> bool:
        return len(self._free) >= n_blocks

    # -- mutation ------------------------------------------------------
    def allocate(self, slot, n_blocks: int, shared=None) -> np.ndarray:
        """Reserve ``n_blocks`` pages for owner ``slot``; returns the
        (nb,) int32 block-table row (-1 padded) to install on device.

        ``shared`` (optional) is a sequence of live page ids adopted as
        the row's prefix — copy-on-write prefix sharing. Shared pages
        bump their refcount instead of consuming the free list; only the
        ``n_blocks - len(shared)`` fresh tail pages are charged, so the
        admission predicate is ``can_allocate(n_blocks - len(shared))``.
        """
        shared = [] if shared is None else [int(p) for p in shared]
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns pages; release first")
        if len(shared) > n_blocks:
            raise RuntimeError(
                f"slot {slot}: {len(shared)} shared pages > {n_blocks} blocks")
        fresh = n_blocks - len(shared)
        if fresh > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {fresh} pages, {len(self._free)} free")
        row = np.full((self.spec.blocks_per_slot,), -1, np.int32)
        for j, p in enumerate(shared):
            if not 0 <= p < self.spec.n_pages or self._ref[p] == 0:
                raise RuntimeError(
                    f"slot {slot}: cannot adopt page {p} (not live)")
            row[j] = p
            self._ref[p] += 1
        for j in range(len(shared), n_blocks):
            p = self._free.pop()
            row[j] = p
            self._ref[p] = 1
        self._owned[slot] = row
        self.total_page_allocations += fresh
        return row

    def retain(self, owner, pages) -> None:
        """Register ``owner`` as an extra reference on live ``pages``
        (all must have refcount > 0). Used by the engine's prefix index
        to keep a retired request's prompt pages adoptable after the
        slot itself releases."""
        if owner in self._owned:
            raise RuntimeError(f"owner {owner!r} already holds pages")
        pages = np.asarray([int(p) for p in pages], np.int32)
        for p in pages:
            if not 0 <= p < self.spec.n_pages or self._ref[p] == 0:
                raise RuntimeError(
                    f"owner {owner!r}: cannot retain page {int(p)} (not live)")
        for p in pages:
            self._ref[p] += 1
        self._owned[owner] = pages

    def owns(self, slot) -> bool:
        """Whether owner ``slot`` currently holds pages from this pool
        (per-shard allocators own only their replica's slots)."""
        return slot in self._owned

    def owned_row(self, slot):
        """The owner's current block-table row, or None (inspection)."""
        row = self._owned.get(slot)
        return None if row is None else row.copy()

    def append(self, slot: int, n_blocks: int = 1) -> np.ndarray:
        """Grow a live slot's reservation by ``n_blocks`` pages (fills the
        first unmapped table entries). Returns the updated row.

        NOT on the engine's admission path: ServeEngine reserves the full
        prompt + max_new worth of pages up front so an admitted request
        can never stall mid-stream. A lazy-reservation scheduler built on
        this primitive must gate its own growth on ``can_allocate`` and
        decide what to do (preempt/swap) when the pool is empty — this
        method just raises."""
        row = self._owned[slot]
        holes = np.nonzero(row < 0)[0]
        if n_blocks > len(holes):
            raise RuntimeError(f"slot {slot}: table full, cannot append")
        if n_blocks > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {n_blocks} pages, {len(self._free)} free")
        for j in holes[:n_blocks]:
            p = self._free.pop()
            row[j] = p
            self._ref[p] = 1
        self.total_page_allocations += n_blocks
        return row

    def release(self, slot) -> int:
        """Drop ``slot``'s reference on its pages; pages whose refcount
        hits zero return to the free list (eviction). No device work: the
        next owner resets page_pos before any read can see the stale
        rows. Returns the number of pages actually freed."""
        row = self._owned.pop(slot, None)
        if row is None:
            return 0
        freed = 0
        for p in row:
            p = int(p)
            if p < 0:
                continue
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        return freed
