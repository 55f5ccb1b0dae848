"""Continuous-batching scheduler: per-step work selection under a token
budget (DESIGN.md §10). A near-verbatim copy of ``repro.serve.scheduler``.

The serving engine used to own admission, preemption, and prefill atomicity
inline — which meant a 32k prompt head-of-line blocked every decoding
request for its entire prefill. This module lifts ALL of that policy into
one host-side object, ``ChunkScheduler``, that the engine merely executes:

  * **admission** — FIFO, head-of-line, bounded by free lanes and (paged
    mode) the free-page budget. Chunked mode admits on the FIRST chunk's
    pages only (continuous batching: a long prompt should not have to
    reserve its whole footprint up front); atomic mode keeps the engine's
    historical worst-case reservation ``pages(min(len+1, capacity))``.
  * **chunk emission** — each prefilling sequence contributes at most one
    fixed-size chunk per step (``chunk_size=None`` = atomic: the whole
    remaining prompt), oldest first, under ``token_budget`` TOTAL tokens
    per step. Decoding lanes are budgeted FIRST (one token each): decode
    latency is never sacrificed to prefill throughput, so no prompt ever
    head-of-line blocks decode. Pages grow chunk-by-chunk (partial-prompt
    page growth); a final chunk also reserves the first decode token's
    boundary page.
  * **preemption at chunk boundaries** — eviction only ever happens
    between steps, never inside a chunk's model call. Two triggers: a
    decoding sequence needs a boundary page from an empty pool (youngest
    active evicted, as before), and a starved chunk round (no decode ran,
    no chunk could take pages) evicts the youngest so the OLDEST always
    makes progress. The engine requeues evicted requests at the queue
    front with their generated prefix; re-prefilling that prefix
    reproduces the stream token-identically (greedy AND seeded sampling —
    the sampling key is a pure function of (request seed, position), see
    serve/sampling.py).
  * **fairness** — arrival-stamped FIFO everywhere: admission order,
    chunk order, decode ordering, victim selection (youngest first).

The scheduler is deliberately model-free — it sees lengths, lanes, and a
``PagedKVCache`` (or None in dense mode), so every policy above is
unit-testable without a model or a device (tests/test_torch_scheduler.py). The engine
(serve/engine.py) translates the returned ``StepPlan`` into at most one
packed zero-offset prefill call, one packed chunk call, and one decode
call per step.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
from collections import deque

from repro_torch.serve.kv_cache import PagedKVCache, pages_for
from repro_torch.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduling policy knobs.

    ``chunk_size=None`` means atomic prefill (the historical behaviour —
    and the degenerate chunking where every chunk covers the whole
    prompt). ``token_budget`` caps the TOTAL tokens a step may process
    (decode lanes count one each, chunks their length); it requires
    ``chunk_size`` — an atomic prefill larger than any finite budget could
    never be scheduled — and must fit at least one full chunk. The default
    budget for chunked mode is ``num_lanes + chunk_size``: every decoder
    plus one full chunk per step.

    ``chunk_multiple`` rounds ``chunk_size`` UP to a multiple at
    construction — the sequence-parallel engine passes its sp shard count
    (DESIGN.md §14) so every FULL chunk splits into equal per-shard slabs
    (the packed call's bucket padding carries the lane alignment; a
    ragged FINAL chunk still pads inside the call and stays exact).
    Rounding happens before the ``token_budget`` validation, so a budget
    must fit the ROUNDED chunk.
    """
    num_lanes: int
    capacity: int
    page_size: int | None = None       # None = dense (no page accounting)
    chunk_size: int | None = None      # None = atomic prefill
    token_budget: int | None = None
    chunk_multiple: int = 1

    def __post_init__(self):
        if self.num_lanes < 1:
            raise ValueError(f"need at least one lane, got {self.num_lanes}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.chunk_multiple < 1:
            raise ValueError(f"chunk_multiple must be positive, "
                             f"got {self.chunk_multiple}")
        if self.chunk_size is not None:
            if self.page_size is None:
                raise ValueError(
                    "chunked prefill appends to paged KV state; the dense "
                    "slot cache only supports atomic prefill "
                    "(chunk_size=None)")
            if self.chunk_size < 1:
                raise ValueError(f"chunk_size must be positive, "
                                 f"got {self.chunk_size}")
            if self.chunk_multiple > 1 and self.chunk_size % self.chunk_multiple:
                object.__setattr__(
                    self, "chunk_size",
                    self.chunk_size
                    + (-self.chunk_size) % self.chunk_multiple)
        if self.token_budget is not None:
            if self.chunk_size is None:
                raise ValueError(
                    "token_budget requires chunk_size: an atomic prefill "
                    "longer than the budget could never be scheduled")
            if self.token_budget < self.chunk_size:
                raise ValueError(
                    f"token_budget ({self.token_budget}) must fit one "
                    f"chunk ({self.chunk_size})")

    @property
    def effective_budget(self) -> int | None:
        if self.token_budget is not None:
            return self.token_budget
        if self.chunk_size is not None:
            return self.num_lanes + self.chunk_size
        return None                     # atomic: unbounded


@dataclasses.dataclass
class SeqState:
    """The scheduler's view of one admitted sequence. ``filled`` counts KV
    rows resident in cache; the sequence is PREFILLING while
    ``filled < target`` and DECODING after."""
    rid: int
    target: int                         # prefill length (resume prompt)
    lane: int
    arrival: int                        # admission stamp (victim ordering)
    filled: int = 0
    cached: int = 0                     # prefix rows mapped from the cache

    @property
    def decoding(self) -> bool:
        return self.filled >= self.target


@dataclasses.dataclass(frozen=True)
class ChunkTask:
    """One prefill chunk: run rows ``[start, start + length)`` of rid's
    resume prompt on lane. ``last`` marks the chunk that completes the
    prefill — its final-row logits yield the first generated token."""
    rid: int
    lane: int
    start: int
    length: int
    last: bool


@dataclasses.dataclass
class StepPlan:
    """One step's work selection. The engine executes it verbatim:
    zero-offset chunks via the packed self-attention prefill, suffix
    chunks via the chunked-prefill model step, then one batched decode
    over ``decode_lanes`` (which already includes lanes whose final chunk
    runs this step). ``preempted`` (rid, lane) pairs were evicted (pages
    released, lanes freed) — the engine requeues them via
    ``resubmit_front`` (or finishes them if their resume prompt hit
    capacity); ``finished_capacity`` pairs were force-finished at
    per-sequence capacity. Lanes ride along because eviction and
    admission can touch the SAME lane within one plan (a prepass-freed
    lane is re-admitted, or a just-admitted request is the starvation
    victim) — the engine resolves victims by the recorded lane, never by
    searching its own slot table. ``dirty`` reports allocator events
    (the engine's cue to re-upload the device page table).
    ``preempt_reasons`` audits WHY each rid in ``preempted`` was evicted
    (``pool-exhaustion`` | ``starvation``) for the request trace."""
    admitted: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    prefill: list[ChunkTask] = dataclasses.field(default_factory=list)
    decode_lanes: list[int] = dataclasses.field(default_factory=list)
    preempted: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    finished_capacity: list[tuple[int, int]] = dataclasses.field(
        default_factory=list)
    deferred_chunks: int = 0
    dirty: bool = False
    preempt_reasons: dict[int, str] = dataclasses.field(default_factory=dict)


class ChunkScheduler:
    """Owns per-step work selection; see module docstring. The engine (or
    a unit test) drives it with::

        sched.submit(rid, prefill_len)        # enqueue
        plan = sched.plan_step()              # select + alloc pages
        ...execute...
        sched.token_appended(rid)             # each decode KV row written
        sched.finish(rid)                     # EOS / budget / error
        sched.resubmit_front(rid, new_len)    # after a preemption
    """

    def __init__(self, cfg: SchedulerConfig, kv: PagedKVCache | None = None,
                 telemetry: Telemetry | None = None):
        if (kv is None) != (cfg.page_size is None):
            raise ValueError("pass a PagedKVCache iff page_size is set")
        if kv is not None and kv.page_size != cfg.page_size:
            raise ValueError(f"allocator page_size {kv.page_size} != "
                             f"scheduler page_size {cfg.page_size}")
        self.cfg = cfg
        self.kv = kv
        self.queue: deque[tuple[int, int]] = deque()   # (rid, prefill_len)
        self.active: dict[int, SeqState] = {}          # lane -> seq
        self.by_rid: dict[int, SeqState] = {}
        self._free_lanes = list(range(cfg.num_lanes))  # kept sorted
        self._arrival = itertools.count(1)
        # observability: every decision lands in the registry with a
        # reason label; the engine passes its bundle so scheduler and
        # engine metrics share one scrape surface (DESIGN.md §15).
        self.tm = telemetry if telemetry is not None else Telemetry()
        reg = self.tm.registry
        self._c_preempt = reg.counter(
            "sched_preemptions", "chunk-boundary evictions",
            labels=("reason",))
        self._c_chunks = reg.counter(
            "sched_chunks_emitted", "prefill chunks handed to the engine")
        self._c_defer = reg.counter(
            "sched_deferred_chunks", "chunks that could not run this step",
            labels=("reason",))

    # -- back-compat views over the registry --------------------------------
    @property
    def preemptions(self) -> int:
        return int(self._c_preempt.total())

    @property
    def chunks_emitted(self) -> int:
        return int(self._c_chunks.total())

    @property
    def deferred_chunks(self) -> int:
        return int(self._c_defer.total())

    def _preempt(self, plan: StepPlan, victim: SeqState, reason: str) -> None:
        plan.preempted.append((victim.rid, victim.lane))
        plan.preempt_reasons[victim.rid] = reason
        self._evict(victim)
        self._c_preempt.inc(reason=reason)
        plan.dirty = True
        tr = self.tm.tracer
        if tr.enabled:
            tr.event("sched", "evict", rid=victim.rid, lane=victim.lane,
                     reason=reason, filled=victim.filled)

    def _defer(self, plan: StepPlan, s: SeqState, reason: str) -> None:
        plan.deferred_chunks += 1
        self._c_defer.inc(reason=reason)
        tr = self.tm.tracer
        if tr.enabled:
            tr.event("sched", "defer", rid=s.rid, lane=s.lane, reason=reason)

    # ------------------------------------------------------------- lifecycle
    @property
    def paged(self) -> bool:
        return self.kv is not None

    def submit(self, rid: int, prefill_len: int) -> None:
        self.queue.append((rid, prefill_len))

    def resubmit_front(self, rid: int, prefill_len: int) -> None:
        """Requeue a preempted request at the queue FRONT (it keeps its
        service priority; its prefill now covers prompt + generated)."""
        self.queue.appendleft((rid, prefill_len))

    def token_appended(self, rid: int) -> None:
        """One decode KV row was written for rid."""
        self.by_rid[rid].filled += 1

    def finish(self, rid: int) -> None:
        """Release rid's lane and pages (EOS / token budget / executor
        decision). Idempotent; unknown rids are ignored."""
        s = self.by_rid.pop(rid, None)
        if s is None:
            return
        del self.active[s.lane]
        bisect.insort(self._free_lanes, s.lane)
        if self.kv is not None:
            self.kv.release(rid)

    def idle(self) -> bool:
        return not self.queue and not self.active

    def lane_of(self, rid: int) -> int:
        return self.by_rid[rid].lane

    def decoding_lanes(self) -> list[int]:
        """Lanes currently in decode state, oldest admission first."""
        return [s.lane for s in self._by_age() if s.decoding]

    def _by_age(self) -> list[SeqState]:
        return sorted(self.active.values(), key=lambda s: s.arrival)

    def _evict(self, s: SeqState) -> None:
        del self.by_rid[s.rid]
        del self.active[s.lane]
        bisect.insort(self._free_lanes, s.lane)
        if self.kv is not None:
            self.kv.release(s.rid)

    # ------------------------------------------------------------------ plan
    def plan_step(self) -> StepPlan:
        plan = StepPlan()
        if self.paged:
            self._decode_prepass(plan)
        self._admit(plan)
        self._emit_chunks(plan)
        # decode set AFTER emission: lanes whose final chunk runs this step
        # decode in the same step (their first token comes from the chunk's
        # logits — same cadence as the historical atomic engine). A paged
        # lane already AT capacity never decodes: its input token's KV
        # write would be dropped (no table row), so the emitted token would
        # be mis-conditioned — the next prepass capacity-finishes it
        # instead, exactly like the historical admit -> prepass -> decode
        # order did.
        plan.decode_lanes = [
            l for l in self.decoding_lanes()
            if not self.paged or self.active[l].filled < self.cfg.capacity]
        return plan

    # ------------------------------------------------- paged decode prepass
    def _decode_prepass(self, plan: StepPlan) -> None:
        """Every decoding sequence needs a page for its next token BEFORE
        the decode call; serve oldest first, evict the youngest active on
        pool exhaustion (oldest-first service guarantees progress), and
        force-finish sequences at per-sequence capacity."""
        ps = self.cfg.page_size
        cap_pages = self.cfg.capacity // ps
        for s in self._by_age():
            if s.rid not in self.by_rid or not s.decoding:
                continue    # evicted as a victim earlier in this pass
            lp = s.filled // ps
            if lp < len(self.kv.table(s.rid)):
                continue    # next write's page already allocated
            if lp >= cap_pages:
                # per-sequence capacity exhausted: finish instead of
                # overrunning (the final token is emitted, never written).
                plan.finished_capacity.append((s.rid, s.lane))
                self._evict(s)
                plan.dirty = True
                continue
            while not self.kv.alloc(s.rid, 1):
                victim = max(self.active.values(), key=lambda v: v.arrival)
                self._preempt(plan, victim, "pool-exhaustion")
                if victim is s:
                    break
            else:
                plan.dirty = True       # table gained a page

    # ------------------------------------------------------------ admission
    def _first_need_pages(self, prefill_len: int, cached_pages: int = 0
                          ) -> int:
        """NEW pages a request must be able to take at admission, beyond
        the ``cached_pages`` it maps from the prefix cache. Chunked mode
        reserves only the first chunk — which now starts at the first
        UNCACHED token (long prompts admit without their full footprint;
        growth and chunk-boundary preemption handle the rest); atomic mode
        keeps the historical worst-case-first-step reservation including
        the first decode token's row, minus the shared prefix."""
        cached_rows = cached_pages * self.cfg.page_size
        if self.cfg.chunk_size is not None:
            return pages_for(min(cached_rows + self.cfg.chunk_size,
                                 prefill_len),
                             self.cfg.page_size) - cached_pages
        return pages_for(min(prefill_len + 1, self.cfg.capacity),
                         self.cfg.page_size) - cached_pages

    def _admit(self, plan: StepPlan) -> None:
        budget = self.kv.free_pages if self.paged else None
        while self._free_lanes and self.queue:
            rid, plen = self.queue[0]
            cached_rows = 0
            if self.paged:
                # Prefix-cache lookup: how many staged full pages hit,
                # clamped BELOW the prompt's last token — the suffix chunk
                # must keep >= 1 row (its logits emit the first generated
                # token) and the boundary page the request writes must be
                # private (copy-on-write rule).
                hit_pages = min(self.kv.peek_prefix(rid),
                                (plen - 1) // self.cfg.page_size)
                need = self._first_need_pages(plen, hit_pages)
                if need > budget:
                    break               # head-of-line: keep arrival order
                fp0 = self.kv.free_pages
                if hit_pages:
                    hit_pages = self.kv.acquire_prefix(rid, hit_pages)
                cached_rows = hit_pages * self.cfg.page_size
                # Acquired pages leave the allocatable pool the moment a
                # retained (LRU) page is re-pinned — charge the budget the
                # ACTUAL pool delta plus the suffix pages _emit_round will
                # allocate this step.
                budget -= (fp0 - self.kv.free_pages) + need
            self.queue.popleft()
            lane = self._free_lanes.pop(0)
            s = SeqState(rid, plen, lane, next(self._arrival),
                         filled=cached_rows, cached=cached_rows)
            self.active[lane] = s
            self.by_rid[rid] = s
            plan.admitted.append((rid, lane))
            plan.dirty = True

    # -------------------------------------------------------- chunk emission
    def _emit_chunks(self, plan: StepPlan) -> None:
        budget = self.cfg.effective_budget
        if budget is None:
            budget = float("inf")
        # decoding lanes are budgeted first: one token each.
        budget -= len(self.decoding_lanes())
        while True:
            emitted, blocked_pages = self._emit_round(plan, budget)
            budget -= emitted
            if emitted or not blocked_pages:
                return
            if self.decoding_lanes() or len(self.active) < 2:
                # decode progressed (pages will free as requests finish),
                # or there is no one to evict — wait.
                return
            # starved chunk round: nothing ran at all and pages are the
            # blocker. Evict the youngest active sequence (by construction
            # not the oldest blocked one: >= 2 active, none decoding) so
            # the oldest always makes progress — eviction happens HERE, at
            # a chunk boundary, never inside a chunk.
            victim = max(self.active.values(), key=lambda v: v.arrival)
            self._preempt(plan, victim, "starvation")

    def _emit_round(self, plan: StepPlan, budget) -> tuple[int, bool]:
        """One oldest-first pass over prefilling sequences; returns (tokens
        emitted, blocked-on-pages?). Stops at the first sequence that
        cannot run — younger sequences never overtake an older one's
        budget or page claim (FIFO fairness)."""
        emitted = 0
        for s in self._by_age():
            if s.decoding:
                continue
            remaining = s.target - s.filled
            n = remaining if self.cfg.chunk_size is None \
                else min(self.cfg.chunk_size, remaining)
            if n > budget - emitted:
                self._defer(plan, s, "budget-exhausted")
                return emitted, False
            last = s.filled + n == s.target
            if self.paged:
                span = s.filled + n
                if last and span < self.cfg.capacity:
                    span += 1           # first decode token's boundary page
                need = (pages_for(min(span, self.cfg.capacity),
                                  self.cfg.page_size)
                        - len(self.kv.table(s.rid)))
                if need > 0 and not self.kv.alloc(s.rid, need):
                    self._defer(plan, s, "page-blocked")
                    return emitted, True
                if need > 0:
                    plan.dirty = True
            plan.prefill.append(ChunkTask(s.rid, s.lane, s.filled, n, last))
            self._c_chunks.inc()
            s.filled += n               # the engine executes unconditionally
            emitted += n
        return emitted, False
