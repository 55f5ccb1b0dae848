"""Port copy of tests/test_scheduler.py for ``repro_torch.serve.scheduler``
(DESIGN.md §10) — policy only, NO model and no device: admission, chunk emission under a token budget,
decode/prefill interleaving, partial-prompt page growth, preemption at
chunk boundaries, fairness, and capacity finishes, driven directly against
``ChunkScheduler`` + the host page allocator."""

import pytest

from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import ChunkScheduler, SchedulerConfig


def make(num_lanes=2, capacity=32, page_size=8, chunk_size=None,
         token_budget=None, num_pages=None, paged=True):
    if not paged:
        return ChunkScheduler(SchedulerConfig(num_lanes, capacity))
    kv = PagedKVCache(num_pages or num_lanes * capacity // page_size,
                      page_size)
    cfg = SchedulerConfig(num_lanes, capacity, page_size=page_size,
                          chunk_size=chunk_size, token_budget=token_budget)
    return ChunkScheduler(cfg, kv=kv)


def drain_prefill(sched, max_steps=100):
    """Run plan_step until no prefill work remains; returns all plans."""
    plans = []
    for _ in range(max_steps):
        plan = sched.plan_step()
        plans.append(plan)
        if not plan.prefill and not plan.admitted:
            break
    return plans


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError, match="dense"):
        SchedulerConfig(2, 32, chunk_size=8)            # chunking needs pages
    with pytest.raises(ValueError, match="chunk_size"):
        SchedulerConfig(2, 32, page_size=8, token_budget=16)  # budget needs chunks
    with pytest.raises(ValueError, match="fit one chunk"):
        SchedulerConfig(2, 32, page_size=8, chunk_size=8, token_budget=4)
    with pytest.raises(ValueError, match="lane"):
        SchedulerConfig(0, 32)
    # chunked default budget: every decoder + one full chunk
    cfg = SchedulerConfig(4, 32, page_size=8, chunk_size=8)
    assert cfg.effective_budget == 12
    assert SchedulerConfig(4, 32).effective_budget is None
    with pytest.raises(ValueError, match="PagedKVCache"):
        ChunkScheduler(SchedulerConfig(2, 32, page_size=8))  # kv missing


# ---------------------------------------------------------------------------
# atomic mode: one chunk covers the whole prompt (historical behaviour)
# ---------------------------------------------------------------------------

def test_atomic_admission_and_single_chunk():
    s = make(num_lanes=2, chunk_size=None)
    s.submit(0, 10)
    s.submit(1, 20)
    s.submit(2, 5)          # no free lane: waits
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [0, 1]
    assert [(t.rid, t.start, t.length, t.last) for t in plan.prefill] == \
        [(0, 0, 10, True), (1, 0, 20, True)]
    # both completed prefill -> decode in the SAME step
    assert sorted(plan.decode_lanes) == sorted(t.lane for t in plan.prefill)
    # rid 2 admitted only after a lane frees
    assert s.plan_step().admitted == []
    s.finish(0)
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [2]


def test_atomic_admission_respects_page_budget_head_of_line():
    # pool of 4 pages of 8; atomic admission reserves pages(min(len+1, cap))
    s = make(num_lanes=3, num_pages=4, chunk_size=None)
    s.submit(0, 17)          # needs pages(18) = 3
    s.submit(1, 17)          # needs 3 more: only 1 left -> blocked
    s.submit(2, 5)           # younger must NOT overtake the blocked head
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [0]
    assert s.kv.used_pages == 3
    s.finish(0)
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [1, 2]


# ---------------------------------------------------------------------------
# chunked mode: emission, budget, interleaving
# ---------------------------------------------------------------------------

def test_chunk_emission_fixed_size_and_final_token_page():
    s = make(num_lanes=1, chunk_size=8, num_pages=8)
    s.submit(0, 20)
    p1 = s.plan_step()
    assert [(t.start, t.length, t.last) for t in p1.prefill] == [(0, 8, False)]
    assert s.kv.used_pages == 1
    p2 = s.plan_step()
    assert [(t.start, t.length, t.last) for t in p2.prefill] == [(8, 8, False)]
    assert s.kv.used_pages == 2
    p3 = s.plan_step()
    # final ragged chunk ALSO reserves the first decode token's page
    # (span 20 + 1 = 21 -> 3 pages)
    assert [(t.start, t.length, t.last) for t in p3.prefill] == [(16, 4, True)]
    assert s.kv.used_pages == 3
    assert p3.decode_lanes == [0]       # decodes the same step it finishes
    assert not p1.decode_lanes and not p2.decode_lanes


def test_token_budget_decode_first_then_chunks():
    # 4 lanes; 2 decoding + prefillers; budget 10 = 2 decode + one 8-chunk
    s = make(num_lanes=4, capacity=64, chunk_size=8, token_budget=10,
             num_pages=24)
    s.submit(0, 4)
    s.submit(1, 4)
    s.plan_step()                       # both prefill fully, start decoding
    s.submit(2, 30)
    plan = s.plan_step()
    assert sorted(plan.decode_lanes)[:2] == [0, 1]
    assert [(t.rid, t.length) for t in plan.prefill] == [(2, 8)]
    # budget 10 too small for a second chunk alongside 2 decoders
    assert plan.deferred_chunks == 0    # only one prefilling seq anyway
    s.submit(3, 30)                     # second prefiller; same-step budget
    plan = s.plan_step()
    assert [(t.rid, t.length) for t in plan.prefill] == [(2, 8)]
    assert plan.deferred_chunks == 1    # rid 3's chunk did not fit


def test_decode_never_blocked_by_long_prefill():
    """The continuous-batching property at the policy level: while a long
    prompt chunks through prefill, decoding sequences run EVERY step."""
    s = make(num_lanes=2, capacity=64, chunk_size=4, token_budget=8,
             num_pages=16)
    s.submit(0, 3)
    s.plan_step()                       # rid 0 now decoding
    s.submit(1, 40)                     # long prompt, 10 chunks
    decode_steps = 0
    for _ in range(12):
        plan = s.plan_step()
        if 0 in [l for l in plan.decode_lanes
                 if s.active.get(l) and s.active[l].rid == 0]:
            decode_steps += 1
        s.token_appended(0)             # engine wrote rid 0's decode row
        if not plan.prefill:
            break
    assert decode_steps >= 10           # decoded through the entire prefill


def test_chunk_order_is_fifo_oldest_first():
    s = make(num_lanes=3, capacity=64, chunk_size=8, token_budget=64,
             num_pages=24)
    for rid in range(3):
        s.submit(rid, 20)
    plan = s.plan_step()
    assert [t.rid for t in plan.prefill] == [0, 1, 2]
    plan = s.plan_step()
    assert [t.rid for t in plan.prefill] == [0, 1, 2]


# ---------------------------------------------------------------------------
# page growth, preemption, capacity
# ---------------------------------------------------------------------------

def test_page_shortfall_defers_when_decode_progresses():
    """If decoders are draining the pool frees itself; a blocked chunk is
    DEFERRED, not used as a preemption excuse."""
    s = make(num_lanes=2, capacity=32, chunk_size=8, token_budget=18,
             num_pages=3)
    s.submit(0, 8)                      # 1 page prefill + boundary page
    s.plan_step()                       # rid 0: pages(9) = 2 used; decoding
    s.submit(1, 20)
    plan = s.plan_step()                # rid 1 first chunk takes page 3
    assert [t.rid for t in plan.prefill] == [(1)]
    plan = s.plan_step()                # rid 1 chunk 2 needs a 4th page
    assert plan.prefill == [] and plan.preempted == []
    assert plan.deferred_chunks == 1
    assert plan.decode_lanes            # rid 0 still decodes
    s.finish(0)                         # decoder drains -> pages free
    plan = s.plan_step()
    assert [t.rid for t in plan.prefill] == [1]


def test_starved_round_preempts_youngest_mid_prefill():
    """No decoder, no chunk can take pages: the youngest active sequence is
    evicted AT A CHUNK BOUNDARY so the oldest always progresses."""
    s = make(num_lanes=2, capacity=32, chunk_size=8, token_budget=18,
             num_pages=4)
    s.submit(0, 24)
    s.submit(1, 24)
    s.plan_step()                       # both admitted, chunk 1 each (2 pg)
    s.plan_step()                       # chunk 2 each (4 pg; pool full)
    plan = s.plan_step()                # rid 0 final chunk needs 2 more
    assert plan.preempted == [(1, 1)]   # youngest evicted mid-prefill
    assert [(t.rid, t.last) for t in plan.prefill] == [(0, True)]
    assert s.preemptions == 1
    # the engine requeues the victim; it re-prefills from scratch
    s.resubmit_front(1, 24)
    s.finish(0)
    plans = drain_prefill(s)
    assert any(t.rid == 1 and t.last for p in plans for t in p.prefill)


def test_decode_boundary_preempts_youngest():
    """A decoding sequence crossing a page boundary on an empty pool evicts
    the youngest active (the historical pool-exhaustion path)."""
    s = make(num_lanes=2, capacity=32, chunk_size=8, token_budget=18,
             num_pages=4)
    s.submit(0, 14)                     # pages(15) = 2
    s.submit(1, 14)
    s.plan_step()                       # chunk 1 each
    s.plan_step()                       # final chunks: 2 pages each; full
    for _ in range(2):                  # decode to the 16-row boundary
        s.token_appended(0)
        s.token_appended(1)
    plan = s.plan_step()
    assert plan.preempted == [(1, 1)]   # youngest loses its pages
    assert plan.decode_lanes == [s.by_rid[0].lane]
    assert s.kv.table(0) and not s.kv.table(1)


def test_starved_round_can_evict_a_same_plan_admission():
    """A request admitted in this very plan can be the starvation victim
    (it is the youngest); it must appear in BOTH plan.admitted and
    plan.preempted, and the retry must keep evicting until the oldest
    progresses."""
    s = make(num_lanes=3, capacity=32, page_size=4, chunk_size=8,
             token_budget=24, num_pages=7)
    s.submit(0, 24)                     # A: final chunk will need 3 pages
    s.submit(1, 16)                     # C: mid-prefill page holder
    s.plan_step()                       # A c1 + C c1 (2 pages each)
    s.plan_step()                       # A c2 (4 held); C final deferred
    s.submit(2, 4)                      # B: first-chunk fits the last page
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [2]
    # B (youngest, admitted this plan) evicted first, then C; A progresses
    assert plan.preempted == [(2, 2), (1, 1)]
    assert [(t.rid, t.last) for t in plan.prefill] == [(0, True)]
    # the victims held nothing / their pages were reclaimed
    assert not s.kv.table(2) and not s.kv.table(1)
    # engine requeues; everyone eventually completes
    s.resubmit_front(2, 4)
    s.resubmit_front(1, 16)
    s.finish(0)
    plans = drain_prefill(s)
    finished = {t.rid for p in plans for t in p.prefill if t.last}
    assert finished == {1, 2}


def test_prepass_evicted_lane_readmitted_same_plan():
    """A decode-boundary eviction frees a lane BEFORE admission runs, so
    the same plan can hand that lane to a queued request: the plan must
    carry the victim's lane so the executor can tell the old tenant from
    the new one."""
    s = make(num_lanes=2, capacity=32, chunk_size=8, token_budget=18,
             num_pages=4)
    s.submit(0, 14)                     # pages(15) = 2
    s.submit(1, 14)
    s.plan_step()                       # chunk 1 each
    s.plan_step()                       # final chunks: pool full (2+2)
    for _ in range(2):                  # both decode to the 16-row boundary
        s.token_appended(0)
        s.token_appended(1)
    s.submit(2, 4)                      # waiting for a lane
    plan = s.plan_step()
    # prepass evicts rid 1 (youngest) for rid 0's boundary page; its freed
    # lane is re-admitted to rid 2 within the SAME plan.
    assert plan.preempted == [(1, 1)]
    assert plan.admitted == [(2, 1)]
    assert [t.rid for t in plan.prefill] == [2]


def test_no_decode_at_capacity_boundary():
    """A lane whose filled length reaches per-sequence capacity never
    decodes (its KV write would be dropped — the emitted token would be
    mis-conditioned); the next prepass capacity-finishes it instead."""
    s = make(num_lanes=1, capacity=16, page_size=8, chunk_size=None,
             num_pages=2)
    s.submit(0, 15)
    plan = s.plan_step()                # atomic prefill; filled 15 < 16
    assert plan.decode_lanes == [0]
    s.token_appended(0)                 # decode wrote row 15 -> filled 16
    plan = s.plan_step()
    assert plan.decode_lanes == []      # never decode AT capacity
    assert plan.finished_capacity == [(0, 0)]


def test_capacity_finish_at_page_table_limit():
    s = make(num_lanes=1, capacity=16, page_size=8, chunk_size=8,
             num_pages=4)
    s.submit(0, 15)
    s.plan_step()
    s.plan_step()
    s.token_appended(0)                 # filled 16 == capacity
    plan = s.plan_step()
    assert plan.finished_capacity == [(0, 0)]
    assert s.idle()
    assert s.kv.used_pages == 0


# ---------------------------------------------------------------------------
# dense mode (no page accounting)
# ---------------------------------------------------------------------------

def test_dense_mode_admission_and_decode():
    s = make(paged=False)
    s.submit(0, 10)
    s.submit(1, 12)
    s.submit(2, 4)
    plan = s.plan_step()
    assert len(plan.admitted) == 2 and len(plan.prefill) == 2
    assert all(t.last for t in plan.prefill)
    assert sorted(plan.decode_lanes) == [0, 1]
    s.finish(0)
    plan = s.plan_step()
    assert [r for r, _ in plan.admitted] == [2]


def test_lane_reuse_lowest_first():
    s = make(num_lanes=3, chunk_size=None)
    for rid in range(3):
        s.submit(rid, 4)
    s.plan_step()
    s.finish(0)
    s.finish(1)
    s.submit(3, 4)
    plan = s.plan_step()
    assert plan.admitted == [(3, 0)]    # lowest freed lane first
