"""Port copies of the allocator and prefix-cache unit tests
(tests/test_paged_kv.py, tests/test_prefix_cache.py) for
``repro_torch.serve.kv_cache`` — host policy only, no model and no device:
page allocation and fragmentation, destination maps, the rolling content
hash, refcounts, LRU retention, suffix-only admission with a private
boundary page."""

import numpy as np
import pytest

from repro_torch.serve.kv_cache import (PagedKVCache, packed_destinations,
                                        pages_for, prefix_page_keys)
from repro_torch.serve.scheduler import ChunkScheduler, SchedulerConfig


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_allocator_alloc_release_and_fragmentation():
    kv = PagedKVCache(num_pages=8, page_size=4)
    assert kv.free_pages == 8 and kv.utilization() == 0.0
    assert kv.alloc(0, 2) and kv.table(0) == [0, 1]
    assert kv.alloc(1, 2) and kv.table(1) == [2, 3]
    assert kv.alloc(2, 2) and kv.table(2) == [4, 5]
    assert kv.utilization() == 6 / 8
    # all-or-nothing: a failed alloc grabs nothing
    assert not kv.alloc(3, 3)
    assert kv.free_pages == 2 and kv.table(3) == []
    # FIFO reuse: released pages queue behind the still-free tail, so the
    # next multi-page table is non-contiguous — fragmentation is normal
    # operating state for the pool.
    assert kv.release(1) == 2
    assert kv.alloc(4, 3) and kv.table(4) == [6, 7, 2]
    assert np.any(np.diff(kv.table(4)) != 1)
    assert kv.peak_in_use == 7
    # table_array: -1 sentinel for unallocated entries / empty rows
    arr = kv.table_array([4, None, 0], pages_per_seq=4)
    assert arr.shape == (3, 4)
    assert list(arr[0]) == [6, 7, 2, -1]
    assert list(arr[1]) == [-1] * 4
    assert list(arr[2]) == [0, 1, -1, -1]


def test_allocator_validation_and_pages_for():
    with pytest.raises(ValueError):
        PagedKVCache(num_pages=0, page_size=4)
    with pytest.raises(ValueError):
        PagedKVCache(num_pages=4, page_size=0)
    assert pages_for(0, 8) == 0
    assert pages_for(1, 8) == 1
    assert pages_for(8, 8) == 1
    assert pages_for(9, 8) == 2


def test_packed_destinations_padding_dropped():
    tables = [[5, 2], [7]]
    offsets = np.array([0, 5, 8])
    dp, do = packed_destinations(tables, offsets[:2], [5, 3], page_size=4,
                                 total=12, num_pages=8)
    assert list(dp[:5]) == [5, 5, 5, 5, 2]
    assert list(do[:5]) == [0, 1, 2, 3, 0]
    assert list(dp[5:8]) == [7, 7, 7]
    assert list(do[5:8]) == [0, 1, 2]
    # bucket-padding tail maps out of bounds (dropped by the scatter)
    assert list(dp[8:]) == [8, 8, 8, 8]


# ---------------------------------------------------------------------------
# hash chain
# ---------------------------------------------------------------------------

def test_prefix_keys_cover_full_pages_only():
    toks = list(range(10))
    assert len(prefix_page_keys("m", toks, 4)) == 2      # 8 of 10 rows
    assert len(prefix_page_keys("m", toks, 4, max_pages=1)) == 1
    assert prefix_page_keys("m", [], 4) == []


def test_prefix_keys_are_a_rolling_chain():
    """keys[i] commits to ALL tokens before page i's end — a KV row is a
    function of its whole prefix, so page identity must be too."""
    a = prefix_page_keys("m", [1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = prefix_page_keys("m", [9, 2, 3, 4, 5, 6, 7, 8], 4)  # page-0 token
    assert a[0] != b[0]
    assert a[1] != b[1], "page-1 key must change when page 0 differs"
    c = prefix_page_keys("m", [1, 2, 3, 4, 5, 6, 7, 9], 4)  # page-1 token
    assert a[0] == c[0] and a[1] != c[1]


def test_prefix_keys_include_model_identity():
    toks = list(range(8))
    assert prefix_page_keys("model-A", toks, 4) != \
        prefix_page_keys("model-B", toks, 4)


# ---------------------------------------------------------------------------
# allocator: refcounts, retention, reclaim
# ---------------------------------------------------------------------------

def test_refcount_share_and_reclaim_at_zero():
    kv = PagedKVCache(8, 4)
    keys = prefix_page_keys("m", list(range(8)), 4)
    kv.stage_prefix(1, keys)
    assert kv.peek_prefix(1) == 0                        # cold
    assert kv.alloc(1, 2)
    assert kv.publish_prefix(1, 2) == 2
    assert kv.cached_pages == 2

    kv.stage_prefix(2, keys)
    assert kv.peek_prefix(2) == 2
    assert kv.acquire_prefix(2) == 2
    shared = kv.table(1)
    assert kv.table(2) == shared                         # same physical pages
    assert all(kv.ref[p] == 2 for p in shared)
    assert kv.used_pages == 2                            # shared, not doubled

    # one sharer's release must never free co-mapped pages
    kv.release(1)
    assert all(kv.ref[p] == 1 for p in shared)
    assert not kv.lru
    assert kv.peek_prefix(2) == 0 or True                # staged popped for 1

    # last sharer: refcount 0 -> RETAINED (indexed, LRU), and allocatable
    kv.release(2)
    assert kv.free_pages == 8
    assert kv.used_pages == 0
    assert kv.cached_pages == 2
    assert set(kv.lru) == set(shared)

    # a third request still hits the retained pages (re-pinned off LRU)
    kv.stage_prefix(3, keys)
    assert kv.acquire_prefix(3) == 2
    assert kv.table(3) == shared
    assert not kv.lru and kv.used_pages == 2


def test_acquire_stops_at_first_chain_miss():
    kv = PagedKVCache(8, 4)
    keys = prefix_page_keys("m", list(range(16)), 4)     # 4 keys
    kv.stage_prefix(1, keys)
    kv.alloc(1, 4)
    kv.publish_prefix(1, 2)                              # only pages 0,1
    kv.stage_prefix(2, keys)
    assert kv.peek_prefix(2) == 2
    assert kv.acquire_prefix(2) == 2
    kv.release(1)


def test_lru_retention_reclaimed_only_under_pressure():
    kv = PagedKVCache(4, 4)
    keys = prefix_page_keys("m", list(range(8)), 4)
    kv.stage_prefix(1, keys)
    kv.alloc(1, 2)
    kv.publish_prefix(1, 2)
    kv.release(1)
    assert kv.cached_pages == 2 and kv.free_pages == 4

    # 2 pages fit without touching the cache...
    assert kv.alloc(2, 2)
    assert kv.cached_pages == 2 and kv.cache_evictions == 0
    # ...but the next 2 must reclaim the retained pages, deindexing them
    assert kv.alloc(2, 2)
    assert kv.cache_evictions == 2
    assert kv.cached_pages == 0 and not kv.lru
    kv.stage_prefix(3, keys)
    assert kv.peek_prefix(3) == 0                        # cache is gone

    # all-or-nothing still holds across the free+retained budget
    assert not kv.alloc(2, 1)


def test_cross_model_keys_never_hit():
    kv = PagedKVCache(8, 4)
    toks = list(range(8))
    kv.stage_prefix(1, prefix_page_keys("model-A", toks, 4))
    kv.alloc(1, 2)
    kv.publish_prefix(1, 2)
    kv.stage_prefix(2, prefix_page_keys("model-B", toks, 4))
    assert kv.peek_prefix(2) == 0
    assert kv.acquire_prefix(2) == 0


# ---------------------------------------------------------------------------
# scheduler: suffix-only admission, private boundary page
# ---------------------------------------------------------------------------

def _drive_cold(sched, kv, rid, plen, keys):
    """Admit + fully prefill rid the way the engine would: plan until the
    sequence decodes, publishing pages as rows materialize."""
    kv.stage_prefix(rid, keys)
    sched.submit(rid, plen)
    for _ in range(32):
        plan = sched.plan_step()
        s = sched.by_rid[rid]
        kv.publish_prefix(rid, s.filled // kv.page_size)
        if s.decoding:
            return
    raise AssertionError("prefill never completed")


def test_admission_counts_only_suffix_pages_and_boundary_stays_private():
    kv = PagedKVCache(16, 4)
    sched = ChunkScheduler(SchedulerConfig(num_lanes=2, capacity=32,
                                           page_size=4, chunk_size=8), kv)
    P = list(range(100, 116))                            # 16 tokens, aligned
    keys = prefix_page_keys("m", P, 4)                   # 4 full pages
    _drive_cold(sched, kv, 0, 16, keys)
    table0 = list(kv.table(0))
    sched.finish(0)

    # warm request, same prompt: hit is clamped BELOW the last token —
    # 3 of 4 pages shared; the 4th (boundary: the request writes row 15
    # there and decodes into it) is freshly allocated.
    kv.stage_prefix(1, keys)
    sched.submit(1, 16)
    fp0 = kv.free_pages
    plan = sched.plan_step()
    s = sched.by_rid[1]
    assert s.cached == 12 and s.filled >= 12
    assert kv.table(1)[:3] == table0[:3]
    assert kv.table(1)[3] != kv.index[keys[3]], \
        "boundary page must be private, never the indexed one"
    # suffix-only footprint: 3 shared pages re-pinned + private pages only
    # for rows [12, 17) — no re-allocation of the shared prefix
    assert fp0 - kv.free_pages <= 3 + 2
    # emitted chunk starts at the first uncached token
    assert plan.prefill and plan.prefill[0].start == 12


def test_unaligned_prompt_hits_all_full_pages():
    kv = PagedKVCache(16, 4)
    sched = ChunkScheduler(SchedulerConfig(num_lanes=2, capacity=32,
                                           page_size=4, chunk_size=8), kv)
    P = list(range(100, 114))                            # 14 tokens
    keys = prefix_page_keys("m", P, 4)                   # 3 full pages
    _drive_cold(sched, kv, 0, 14, keys)
    sched.finish(0)
    kv.stage_prefix(1, keys)
    sched.submit(1, 14)
    sched.plan_step()
    # (14-1)//4 = 3: every full page shared, suffix = rows [12, 14)
    assert sched.by_rid[1].cached == 12
