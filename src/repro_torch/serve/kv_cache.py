"""Paged KV cache: the mask IR's kv block as the unit of cache ALLOCATION
(port of ``repro.serve.kv_cache``: the host allocator is a copy; the
packed-prefill page scatter is a PyTorch in-place write).

FlashAttention processes attention in SRAM-sized tiles so HBM traffic
scales with the tiles actually touched; the serving-side dual is to
allocate cache memory in the same tiles. The device state is a shared page
pool — per-layer ``(L, hkv, num_pages, page_size, hd)`` arrays — and each
sequence owns a *page table* mapping its logical kv blocks (positions
``[t*page_size, (t+1)*page_size)``) to physical pool pages. Consequences:

  * a request's resident bytes are ``ceil(len / page_size)`` pages, not a
    fixed per-slot capacity — short requests stop paying for long ones;
  * admission is bound by the free-page budget, not by slot count, so the
    decode batch can hold many more concurrent short sequences than the
    dense ``num_slots x capacity`` cache at equal HBM;
  * because the page IS the mask IR's kv block (page_size == block_k),
    ``masks.paged_block_layout`` classifies pages SKIP / FULL / PARTIAL
    exactly as the contiguous kernels classify blocks — SKIP (and
    unallocated) pages are provably never dereferenced;
  * pages freed by finished sequences are reused immediately; after churn
    a sequence's pages are scattered through the pool (fragmentation is
    free — the indirection already pays for it).

Copy-on-write **prefix caching** (DESIGN.md §12) rides on the same
allocator: at production scale most requests share a system prompt or
few-shot prefix, and the most IO-efficient prefill is the one that never
runs. Full pages whose token content is known are *published* into a
content-hash index (a rolling hash chain over ``(model identity, page
tokens)`` — see ``prefix_page_keys``); a later request whose prompt hashes
to the same chain *acquires* those pages read-only into its own table
(per-page refcounts) and prefills only the unseen suffix. Pages released
by a finished or evicted request drop to refcount 0 but STAY indexed on an
LRU list; the allocator reclaims them lazily, only when the free list
runs dry — so the pool doubles as a prefix cache at zero reserved HBM.
The copy-on-write rule is structural: only FULL pages are ever published
or acquired, and the hit is clamped below the prompt's last token, so the
partially-filled boundary page every request writes (suffix rows, then
decode rows) is always private — a shared page is never written.

This module owns the HOST side: the allocator (free list, per-sequence
tables, refcounts, prefix index, utilization counters), the host-numpy
destination-index builders, and the packed-prefill page scatter. The
device pool itself lives in the engine's decode state
(``Model.init_paged_decode_state``) and is updated in place.
"""

from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from repro_torch.core import masks
from repro_torch.models.attention_layer import write_page_rows
from repro_torch.telemetry.metrics import MetricsRegistry

__all__ = ["PagedKVCache", "scatter_packed_segments",
           "packed_destinations", "chunk_destinations", "paged_prefix_lists",
           "pages_for", "prefix_page_keys"]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens cache rows."""
    return -(-max(n_tokens, 0) // page_size)


def prefix_page_keys(model_key: str, tokens, page_size: int,
                     max_pages: int | None = None) -> list[str]:
    """Rolling content-hash chain over the FULL pages of ``tokens``.

    ``keys[i]`` identifies the KV content of page ``i`` — it hashes the
    model identity and EVERY token in ``[0, (i+1)*page_size)`` (via the
    chain), because a KV row at position p is a function of the whole
    token prefix ``tokens[0..p]``, not of the page's own tokens alone.
    Two requests therefore share page ``i`` iff their first ``(i+1)``
    pages of tokens are identical under the same model — a chain-prefix
    match is exactly the KV-identity condition. ``model_key`` seeds the
    chain so caches can never collide across model / dtype / shape
    identities even if an index were ever shared or serialized.
    """
    n_full = len(tokens) // page_size
    if max_pages is not None:
        n_full = min(n_full, max_pages)
    keys: list[str] = []
    h = hashlib.sha256(repr(model_key).encode()).digest()
    for p in range(n_full):
        page = np.asarray(tokens[p * page_size:(p + 1) * page_size],
                          np.int64)
        h = hashlib.sha256(h + page.tobytes()).digest()
        keys.append(h.hex())
    return keys


class PagedKVCache:
    """Host-side page allocator: free list + per-sequence page tables.

    Pages are identified by index into the pool's page dim. The free list
    is a FIFO deque: pages released by finished sequences go to the back,
    so sustained churn naturally produces non-contiguous (fragmented)
    tables — which the indirection makes costless, and which the tests
    exercise deliberately.

    Prefix caching adds three structures on top (module docstring /
    DESIGN.md §12): ``ref`` counts how many tables map each page; the
    ``index`` maps a rolling content-hash key to the one physical page
    holding that KV content; ``lru`` holds indexed pages whose refcount is
    0 — still valid cache, reclaimed lazily (oldest first, deindexing)
    only when the free list runs dry. A page is thus in exactly one of
    three states: mapped (ref > 0), retained (ref == 0, on ``lru``), or
    free. ``free_pages`` counts free + retained — both are allocatable —
    so admission-budget math is unchanged for callers.
    """

    def __init__(self, num_pages: int, page_size: int, registry=None):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"paged KV cache needs at least one page of at least one "
                f"row, got num_pages={num_pages}, page_size={page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: collections.deque[int] = collections.deque(range(num_pages))
        self.tables: dict[int, list[int]] = {}       # rid -> physical pages
        # --- prefix cache state
        self.ref: dict[int, int] = {}                # page -> mapping count
        self.index: dict[str, int] = {}              # content key -> page
        self.page_key: dict[int, str] = {}           # page -> content key
        self.lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.staged: dict[int, list[str]] = {}       # rid -> prompt page keys
        # observability: registry-backed (telemetry/metrics.py) so the
        # engine's bundle scrapes allocator behaviour alongside its own
        # counters; the historical attribute names are property views. A
        # standalone cache (unit tests) gets a private registry.
        self._reg = registry if registry is not None else MetricsRegistry()
        self._c_alloc = self._reg.counter(
            "kv_alloc_events", "pages allocated to tables")
        self._c_free = self._reg.counter(
            "kv_free_events", "pages that left the used set")
        self._g_peak = self._reg.gauge(
            "kv_peak_in_use", "max pages simultaneously in use")
        self._c_shared = self._reg.counter(
            "kv_shared_maps", "pages mapped via a prefix hit")
        self._c_cache_evict = self._reg.counter(
            "kv_cache_evictions", "retained pages reclaimed under pressure")

    # -- back-compat views over the registry --------------------------------
    @property
    def alloc_events(self) -> int:
        return int(self._c_alloc.total())

    @property
    def free_events(self) -> int:
        return int(self._c_free.total())

    @property
    def peak_in_use(self) -> int:
        return int(self._g_peak.value())

    @property
    def shared_maps(self) -> int:
        return int(self._c_shared.total())

    @property
    def cache_evictions(self) -> int:
        return int(self._c_cache_evict.total())

    # ------------------------------------------------------------- accounting
    @property
    def used_pages(self) -> int:
        """Pages some live request maps (ref > 0)."""
        return self.num_pages - self.free_pages

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + zero-ref retained cache pages
        (the LRU list is reclaimed on demand, so it IS budget)."""
        return len(self.free) + len(self.lru)

    @property
    def cached_pages(self) -> int:
        """Pages currently in the content index (mapped or retained)."""
        return len(self.index)

    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    # ------------------------------------------------------------- alloc/free
    def _take_free_page(self) -> int:
        """Pop an allocatable page: free list first; under pressure reclaim
        the LRU-oldest retained page, dropping its index entry."""
        if self.free:
            return self.free.popleft()
        page, _ = self.lru.popitem(last=False)
        self._deindex(page)
        self._c_cache_evict.inc()
        return page

    def _deindex(self, page: int) -> None:
        key = self.page_key.pop(page, None)
        if key is not None and self.index.get(key) == page:
            del self.index[key]

    def alloc(self, rid: int, n_pages: int) -> bool:
        """Extend rid's table by n_pages of PRIVATE (ref=1, unindexed)
        pages. All-or-nothing: returns False (allocating nothing) when the
        pool cannot satisfy the request."""
        if n_pages > self.free_pages:
            return False
        table = self.tables.setdefault(rid, [])
        for _ in range(n_pages):
            page = self._take_free_page()
            self.ref[page] = 1
            table.append(page)
        self._c_alloc.inc(n_pages)
        self._g_peak.max_update(self.used_pages)
        return True

    def release(self, rid: int) -> int:
        """Drop all of rid's page mappings (EOS / finish / preemption).

        Each page's refcount falls by one; only pages nobody else maps
        actually leave the used set — a sharer's preemption can never free
        a co-mapped page. Zero-ref pages that hold published (indexed)
        prefix content are RETAINED on the LRU list instead of freed; the
        rest go back to the free list. Returns pages that left the used
        set."""
        table = self.tables.pop(rid, [])
        self.staged.pop(rid, None)
        released = 0
        for page in table:
            self.ref[page] -= 1
            if self.ref[page] > 0:
                continue
            del self.ref[page]
            released += 1
            if page in self.page_key:
                self.lru[page] = None        # newest at the back
                self.lru.move_to_end(page)
            else:
                self.free.append(page)
        self._c_free.inc(released)
        return released

    # ---------------------------------------------------------- prefix cache
    def stage_prefix(self, rid: int, keys: list[str]) -> None:
        """Declare rid's prompt content: ``keys[i]`` is the rolling hash of
        its i-th FULL page (``prefix_page_keys``). Staged at submit (and
        re-staged on preemption resubmit); consumed by peek/acquire at
        admission and publish at chunk boundaries."""
        self.staged[rid] = list(keys)

    def peek_prefix(self, rid: int) -> int:
        """Longest CONTIGUOUS run of rid's staged keys present in the
        index, without mapping anything. The walk stops at the first miss:
        the rolling chain means page i is only usable if pages 0..i-1 hit
        too, and LRU reclaim can evict mid-chain."""
        n = 0
        for key in self.staged.get(rid, []):
            if key not in self.index:
                break
            n += 1
        return n

    def acquire_prefix(self, rid: int, max_pages: int | None = None) -> int:
        """Map rid's hit prefix pages (read-only share): walk the staged
        chain, bump each hit page's refcount, append it to rid's table.
        Retained pages leave the LRU list (they are budget again only when
        re-released). Returns pages mapped. Caller clamps ``max_pages``
        below the prompt's last token so the boundary page — the one the
        request will WRITE — is never shared."""
        keys = self.staged.get(rid, [])
        if max_pages is not None:
            keys = keys[:max_pages]
        table = self.tables.setdefault(rid, [])
        if table:
            raise ValueError(
                f"acquire_prefix: rid {rid} already holds pages — hits "
                f"must be mapped before any private allocation")
        n = 0
        for key in keys:
            page = self.index.get(key)
            if page is None:
                break
            if self.ref.get(page, 0) == 0:
                self.lru.pop(page, None)
            self.ref[page] = self.ref.get(page, 0) + 1
            table.append(page)
            n += 1
        self._c_shared.inc(n)
        self._g_peak.max_update(self.used_pages)
        return n

    def publish_prefix(self, rid: int, n_full_pages: int) -> int:
        """Index rid's first ``n_full_pages`` pages under their staged keys
        — called once their KV rows are materialized (chunk scatter /
        finish). Pages acquired from the index are already keyed and are
        skipped; a key already indexed to a different page keeps the
        existing entry (first writer wins — both hold identical content,
        double-indexing would orphan one). Returns newly indexed pages."""
        keys = self.staged.get(rid, [])
        table = self.tables.get(rid, [])
        new = 0
        for p in range(min(n_full_pages, len(keys), len(table))):
            page = table[p]
            key = keys[p]
            if self.page_key.get(page) == key or key in self.index:
                continue
            self.index[key] = page
            self.page_key[page] = key
            new += 1
        return new

    def table(self, rid: int) -> list[int]:
        return self.tables.get(rid, [])

    def table_array(self, row_rids: list[int | None],
                    pages_per_seq: int) -> np.ndarray:
        """(B, pages_per_seq) int32 device-ready page table; -1 =
        unallocated (rows without a sequence are all -1 and therefore
        all-SKIP for the mask IR and write-dropped by the decode scatter)."""
        out = np.full((len(row_rids), pages_per_seq), -1, np.int32)
        for row, rid in enumerate(row_rids):
            if rid is None:
                continue
            t = self.tables.get(rid, [])
            out[row, :len(t)] = t
        return out


# ---------------------------------------------------------------------------
# Packed prefill -> pages: ONE traced scatter
# ---------------------------------------------------------------------------

def chunk_destinations(tables: list[list[int]], starts: list[int],
                       offsets, lengths: list[int], page_size: int,
                       total: int, num_pages: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Map every packed CHUNK row to its (physical page, in-page offset)
    destination: chunk i occupies its sequence's LOGICAL positions
    ``[starts[i], starts[i] + lengths[i])`` (partial-prompt page growth —
    the sequence's table already covers those positions). Rows outside any
    chunk (bucket padding) map to page ``num_pages`` — out of bounds,
    dropped by the scatter. Host numpy, data to one jitted scatter whose
    trace depends only on the bucketed packed length."""
    dest_page = np.full((total,), num_pages, np.int32)
    dest_off = np.zeros((total,), np.int32)
    for table, st, o, n in zip(tables, starts, offsets, lengths):
        pos = np.arange(st, st + n)
        dest_page[o:o + n] = np.asarray(table, np.int32)[pos // page_size]
        dest_off[o:o + n] = pos % page_size
    return dest_page, dest_off


def packed_destinations(tables: list[list[int]], offsets: np.ndarray,
                        lengths: list[int], page_size: int, total: int,
                        num_pages: int) -> tuple[np.ndarray, np.ndarray]:
    """Map every packed-token position to its (physical page, in-page
    offset) destination — the whole-prompt special case of
    ``chunk_destinations`` (every chunk starts at logical position 0).
    This is what kills the dense engine's per-(slot, length)
    ``_insert_segment`` retrace family."""
    return chunk_destinations(tables, [0] * len(tables), offsets, lengths,
                              page_size, total, num_pages)


def paged_prefix_lists(tables: list[list[int]], spans: list[int],
                       page_size: int, total_pages: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the chunked-prefill KV side WITHOUT gathering: segment i's
    logical prefix ``[0, spans[i])`` (history + the chunk just scattered)
    stays in the pool, and the kernel reads it through this page list —
    segment i's ``pages_for(spans[i])`` physical pages packed back-to-back
    in PAGE-ALIGNED slots. Returns:

      * ``page_list`` (total_pages,) int32 — physical page per kv block;
        ``-1`` on unused slots (the kernel's index_map never reads them:
        ``masks.paged_prefill_block_layout`` forces those columns SKIP);
      * ``kv_seg``  (total_pages*page_size,) int32 — segment id per logical
        kv row, ``SEG_PAD_KV`` on dead rows (last-page tails + unused
        slots) so the fused mask kills them on every impl;
      * ``kv_pos``  (same shape) int32 — position within the segment,
        ``POS_PAD`` on dead rows (causally unreachable).

    This replaces the per-layer ``gather_sources`` row copy: the host emits
    page indices once per chunk step; zero KV bytes move per layer."""
    page_list = np.full((total_pages,), -1, np.int32)
    rows = total_pages * page_size
    kv_seg = np.full((rows,), masks.SEG_PAD_KV, np.int32)
    kv_pos = np.full((rows,), masks.POS_PAD, np.int32)
    slot = 0
    for seg, (table, span) in enumerate(zip(tables, spans)):
        n_pages = pages_for(span, page_size)
        if slot + n_pages > total_pages:
            raise ValueError(
                f"paged_prefix_lists: segment {seg} needs {n_pages} page "
                f"slots at offset {slot} but only {total_pages} exist — "
                f"bucket the packed kv length in page multiples")
        page_list[slot:slot + n_pages] = np.asarray(table, np.int32)[:n_pages]
        r0 = slot * page_size
        kv_seg[r0:r0 + span] = seg
        kv_pos[r0:r0 + span] = np.arange(span)
        slot += n_pages
    return page_list, kv_seg, kv_pos


def scatter_packed_segments(pool_caches, packed_caches, dest_page, dest_off):
    """Write a packed prefill's K/V rows straight into pool pages, in place.

    pool leaves: (L, hkv, num_pages, page_size, hd); packed leaves
    (L, 1, hkv, S, hd); dest_page/dest_off: (S,) int32 with out-of-range
    page ids (``num_pages``) for padding rows, which are dropped — the
    explicit form of JAX's ``mode="drop"``. Replaces the jitted, donated
    scatter of the JAX engine: one in-place pass per admitted batch.
    Returns ``pool_caches``."""
    with torch.inference_mode():
        for name, pool in pool_caches["kv"].items():
            src = packed_caches["kv"][name][:, 0]        # (L, hkv, S, hd)
            # fold the layer axis into the head axis: one write for all layers
            L, hkv = pool.shape[:2]
            write_page_rows(pool.view(L * hkv, *pool.shape[2:]),
                        src.reshape(L * hkv, *src.shape[2:]),
                        dest_page, dest_off)
    return pool_caches
