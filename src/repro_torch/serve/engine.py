"""Serving engine: a thin EXECUTOR for the continuous-batching scheduler
over a PAGED KV cache (the default) or a fixed-slot dense cache, on one
device (port of ``repro.serve.engine``).

Division of labour (DESIGN.md §10):

  * **ChunkScheduler** (serve/scheduler.py) owns every policy decision —
    admission under lane + free-page budgets, per-step chunk emission under
    a token budget, page growth, preemption at chunk boundaries, capacity
    finishes.
  * **ServingEngine** executes each ``StepPlan``: at most one packed
    zero-offset prefill (chunks starting at position 0 — packed
    self-attention, then one in-place page write), one packed suffix-chunk
    call (``Model.prefill_chunk_paged``: write the chunks' K/V rows into
    pages, attend each segment's prefix in place through a page list), and
    one batched decode step. It owns the device state (pool, page table,
    kv_len mirror) and the Request bookkeeping (EOS, token budgets,
    preemption requeue-vs-finish).

Dense mode (``paged=False``) keeps one fixed-capacity cache row per lane
and atomic prefill, driven through the same scheduler without page
accounting: drained requests prefill in ONE packed call whose K/V rows are
copied into their slots, and decode runs the contiguous split-KV kernel
(``use_decode_kernel``) or its plain version. Families with recurrent
state (SSM, hybrid) can neither page nor pack: they serve in dense mode
(the default for them; ``paged=True`` raises), each admission one
UNPADDED batch-1 ``Model.prefill`` (padding would run the recurrence past
the prompt) whose state overwrites the slot's whole state, every leaf.

Prefix caching (on by default in paged mode): ``submit`` stages the
prompt's rolling content hash with the allocator, admission maps any
indexed full-page prefix read-only into the new request's table, and the
chunk executors publish pages as their rows materialize (kv_cache.py,
DESIGN.md §12).

Every packed zero-offset prefill counts the attention blocks its compiled
causal + segment layout proves skippable (``blocks_skipped``,
``blocks_total``, ``last_prefill_layout_density``), as the JAX engine does.

Where the JAX engine donates the cache through jitted step functions, this
engine updates the cache tensors in place. Entry points run on ``cuda``
unless ``device="cpu"`` is passed; there is no fallback between the two.
On the card a paged engine takes pages of 8, 16, 32 or 64 rows, the sizes
its kernels take, and refuses any other at construction
(``tuning.check_page_size``); on the CPU any page dividing the capacity
serves, as in the JAX engine. A model that reads frontend embeddings (the
encoder-decoder) is refused at construction (``require_token_inputs``):
a request carries tokens alone, as in the JAX engine, which cannot serve
it either.

Tensor and sequence parallelism (``tp``, ``sp``; DESIGN.md §13-§14) run
as SPMD ranks, one process a shard, each with its own engine over the
same ``ServeMesh`` (``mesh``; ``distributed.meshes``): the data plane is
sharded and the control plane is host-global. The scheduler, allocator,
page tables and prefix index run on every rank and, being deterministic,
make the same decisions with the same page indices everywhere. Each rank
holds its head slice of the weights (``distributed.sharding.shard_params``
of the full tree it is given) and of the pool (``num_kv_heads / tp``
heads), and runs ``shard_model``, a per-shard model view whose head and
d_ff counts are the rank's; the host bookkeeping (the IO ledger,
``io_model`` accounting, prefix keys) keeps the global config. Embedding
and ``lm_head`` stay replicated, so after the two all-reduces of a layer
activations and logits are too, and sampling (a pure function of seed
and position) needs no collective. At sp > 1 every prefill goes through
the chunk step, each sp rank passing its slab of the packed q rows while
the kv side stays whole; decode is sp-replicated. The last-row logits of
the chunks a step completes are then gathered over the sp group, once a
step, outside the model (the reference assembles its sp-sharded logits
the same way, outside its traced step). ``step_census`` keeps, by step
kind, the collectives of the last step's model call, counted by the
mesh's ``collectives`` counter: ``2 * num_layers`` ``all_reduce`` calls
for decode and the packed prefill, and
``sharding.expected_sp_prefill_census`` for a chunk step.

Every executed step is priced in predicted HBM bytes by the IO ledger
(``telemetry.io_ledger``: ``self.tm.ledger``) next to its wall time, which
ends where the step already waits for the host (the sampled tokens'
read-back; a chunk that completes no prompt has none, and its time is the
host's enqueue time). The price model takes one representative tile of
the analytic chooser (``tuning.choose_tile_config`` at the prefill bucket,
per tensor-parallel shard) and the q-major loop order. The decode
geometry resolves once at construction (``tuning.resolve_decode_geometry``;
timed there when autotuning is on). Prefix-cache hits are
credited as bytes not spent (``prefill_hbm_bytes_saved``,
``io_model.prefix_cache_hbm_bytes_saved``), and the paged chunk path
counts the prefix gathers it never runs
(``prefill_gather_bytes_eliminated``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import io_model, masks
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.masks import POS_PAD, SEG_PAD_Q
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as dist_sharding
from repro_torch.kernels import tuning
from repro_torch.models.model_zoo import Model, require_token_inputs
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import sampling
from repro_torch.serve.scheduler import ChunkScheduler, ChunkTask, SchedulerConfig
from repro_torch.telemetry import IOLedger, ServePriceModel, Telemetry
from repro_torch.telemetry.metrics import MetricsRegistry


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    params: sampling.SamplingParams = dataclasses.field(
        default_factory=sampling.SamplingParams)
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # submit wall-clock and first-generated-token wall-clock (None until the
    # last prefill chunk completes; survives preempt->resume).
    t_submit: float = 0.0
    t_first: float | None = None

    @property
    def resume_tokens(self) -> list[int]:
        """Prefill input: the prompt plus anything generated before a
        preemption; re-running it reproduces the continuation."""
        return self.prompt + self.output


def _params_device(params) -> torch.device:
    return params["embed"].device


class ServingEngine:
    def __init__(self, model: Model, params, *, num_slots: int,
                 capacity: int, eos_id: int | None = None,
                 packed_prefill: bool = True, prefill_bucket: int = 64,
                 paged: bool | None = None,
                 page_size: int = 16, num_pages: int | None = None,
                 chunk_size: int | None = None,
                 token_budget: int | None = None,
                 prefix_cache: bool | None = None,
                 tp: int = 1, sp: int = 1, sp_strategy: str | None = None,
                 mesh=None, trace: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if _params_device(params).type != self.device.type:
            raise ValueError(f"params live on {_params_device(params)}, the "
                             f"engine runs on {self.device}")
        require_token_inputs(model.cfg, "the serving engine")
        self.model = model
        self.params = params
        self.B = num_slots
        self.capacity = capacity
        self.eos_id = eos_id
        # packed prefill widths pad to a multiple of this many rows
        self.packed_prefill = packed_prefill and model.supports_packed_prefill()
        self.prefill_bucket = prefill_bucket
        can_page = model.supports_paged_decode()
        self.paged = can_page if paged is None else bool(paged)
        if self.paged and not can_page:
            raise ValueError(
                f"paged decode needs a per-token KV cache; family "
                f"{model.cfg.family!r} (hybrid={model.cfg.hybrid}) carries "
                f"recurrent/encoder state that cannot be paged")
        if chunk_size is not None and not self.paged:
            raise ValueError(
                "chunked prefill appends to paged KV state; the dense slot "
                "cache only supports atomic prefill (chunk_size=None)")
        if prefix_cache and not self.paged:
            raise ValueError(
                "prefix caching shares pool pages across page tables; the "
                "dense slot cache has neither (prefix_cache=False)")
        if token_budget is not None and not self.paged:
            raise ValueError("token_budget requires chunked (paged) mode")
        self.prefix_cache = (self.paged if prefix_cache is None
                             else bool(prefix_cache))
        self._check_parallel(model.cfg, tp, sp, sp_strategy, capacity,
                             chunk_size, self.device)
        self.tm = Telemetry(trace=trace)
        reg = self.tm.registry
        self._c_prefill_calls = reg.counter(
            "serve_prefill_calls", "model prefill invocations")
        self._c_decode_calls = reg.counter(
            "serve_decode_calls", "batched decode invocations")
        # blocks the packed prefill's compiled layout proves skippable
        # (cross-document and padded-tail tiles), cumulated
        self._c_blocks_skipped = reg.counter(
            "serve_blocks_skipped", "mask-IR blocks proven skippable")
        self._c_blocks_total = reg.counter(
            "serve_blocks_total", "mask-IR blocks in packed layouts")
        self._g_layout_density = reg.gauge(
            "serve_prefill_layout_density",
            "1 - skip rate of the last packed layout")
        self._g_layout_density.set(1.0)
        self._c_preemptions = reg.counter(
            "serve_preemptions", "preempted requests requeued/finished")
        self._g_peak_active = reg.gauge(
            "serve_peak_active", "max concurrently active lanes")
        self._g_step = {
            name: reg.gauge(f"serve_step_{name}",
                            f"last step's {name.replace('_', ' ')}")
            for name in ("active", "occupancy", "pool_utilization",
                         "prefill_tokens", "decode_tokens",
                         "deferred_chunks", "queued")}
        self._h_ttft = reg.histogram(
            "serve_ttft_s", "submit -> first generated token (s)")
        self._h_tok = reg.histogram(
            "serve_tok_latency_s", "per-token decode step latency (s)")
        self._c_prefix_lookups = reg.counter(
            "serve_prefix_lookups", "admissions with lookup enabled")
        self._c_prefix_hits = reg.counter(
            "serve_prefix_hits", "admissions mapping >= 1 page")
        self._c_prefix_pages = reg.counter(
            "serve_prefix_pages_shared", "pages mapped from the index")
        self._c_tokens_skipped = reg.counter(
            "serve_prefill_tokens_skipped", "prompt rows never prefilled")
        self._c_hbm_saved = reg.counter(
            "serve_prefill_hbm_bytes_saved", "io_model credit for those rows")
        # hot-path IO the in-place kv side does not pay: the bytes the
        # per-layer prefix gather (read pages + write packed rows, K and V)
        # would have moved for the same chunk steps.
        self._c_gather_elim = reg.counter(
            "serve_prefill_gather_bytes_eliminated",
            "prefix-gather bytes the paged chunk path avoids")
        self._stepped = False
        self._step_idx = 0
        self._preempted_rids: set[int] = set()
        self.step_census: dict[str, dict[str, int]] = {}

        cfg = model.cfg
        self._shard(model, params, mesh)
        # seeds every content-hash chain: pages never collide across model
        # weights / dtype / attention geometry identities.
        self._model_key = (f"{cfg.name}|{cfg.family}|{cfg.dtype}"
                           f"|L{cfg.num_layers}|hq{cfg.num_heads}"
                           f"|hkv{cfg.num_kv_heads}|d{cfg.head_dim}"
                           f"|V{cfg.vocab_size}")
        self.requests: dict[int, Request] = {}
        self.slot_req: list[Request | None] = [None] * num_slots
        self.finished: list[Request] = []
        self.next_token = np.zeros((num_slots,), np.int32)
        self._rid = itertools.count()

        if self.paged:
            if self.device.type == "cuda":
                tuning.check_page_size(page_size)
            if capacity % page_size:
                raise ValueError(
                    f"capacity ({capacity}) must be a multiple of page_size "
                    f"({page_size}): the page is the mask-IR kv block and "
                    f"the per-sequence page table has capacity/page_size "
                    f"entries")
            self.page_size = page_size
            self.pages_per_seq = capacity // page_size
            if num_pages is None:
                num_pages = num_slots * self.pages_per_seq
            self.kv = kvc.PagedKVCache(num_pages, page_size,
                                       registry=self.tm.registry)
            self.state = self.shard_model.init_paged_decode_state(
                num_slots, num_pages, page_size, self.pages_per_seq,
                device=self.device)
            self._kv_len_h = np.zeros((num_slots,), np.int64)
            self._paged_dirty = True     # device table/kv_len need upload
            # kv-side width bucket for suffix chunks, rounded UP to a page
            # multiple: the in-place kv side is a page LIST.
            ckb = max(self.prefill_bucket, 2 * (chunk_size or 0))
            self.chunk_kv_bucket = ckb + (-ckb) % page_size
            self.scheduler = ChunkScheduler(
                SchedulerConfig(num_lanes=num_slots, capacity=capacity,
                                page_size=page_size, chunk_size=chunk_size,
                                token_budget=token_budget,
                                # full chunks split into equal sp slabs
                                chunk_multiple=self.sp),
                kv=self.kv, telemetry=self.tm)
        else:
            self.state = model.init_decode_state(num_slots, capacity,
                                                 device=self.device)
            self.scheduler = ChunkScheduler(
                SchedulerConfig(num_lanes=num_slots, capacity=capacity),
                telemetry=self.tm)

        # Resolve the decode kernel geometry ONCE at construction: a pinned
        # split count (or block) that does not divide the cache fails here,
        # not inside the first decode step (with autotuning on, it is timed
        # here).
        if cfg.use_decode_kernel:
            block_k, splits = tuning.resolve_decode_geometry(
                capacity, None if self.paged else cfg.attn_block_k,
                cfg.num_decode_splits, head_dim=cfg.head_dim,
                dtype=cfg.dtype, page_size=page_size if self.paged else None,
                shards=self.tp, on_card=self.device.type == "cuda",
                device=self.device)
            self.num_decode_splits = splits
            if not self.paged:
                self.decode_block_k = block_k

        # IO-ledger pricing: the model geometry and ONE representative
        # tile from the analytic chooser (construction never triggers a
        # timing run), walked q-major (the Hopper bodies' loop order)
        rep = tuning.choose_tile_config(
            self.prefill_bucket, max(capacity, self.prefill_bucket),
            cfg.head_dim, dtype=cfg.dtype, backward=False,
            heads_q=max(1, cfg.num_heads // self.tp),
            heads_kv=max(1, cfg.num_kv_heads // self.tp), shards=self.tp)
        self.tm.ledger = IOLedger(ServePriceModel(
            d=cfg.head_dim, heads_q=cfg.num_heads,
            heads_kv=cfg.num_kv_heads, d_model=cfg.d_model,
            layers=cfg.num_layers, elt=tuning.elt_bytes(cfg.dtype),
            block_q=rep.block_q, block_k=rep.block_k, kv_major=rep.kv_major,
            tp=self.tp, sp=self.sp,
            sp_strategy=self.sp_strategy or "replicated"))

    # ----------------------------------------- tensor/sequence parallelism
    def _check_parallel(self, cfg, tp: int, sp: int, sp_strategy,
                        capacity: int, chunk_size: int | None,
                        device="cpu") -> None:
        """The reference's construction checks for ``tp`` and ``sp``, in its
        words: paged mode and the dense family only, whole kv heads (with
        their q-head groups) and a whole share of d_ff per tp rank; at sp
        > 1 the prefill bucket rounded up to ``sp * io_model.SUBLANES``
        rows (so that each slab is whole rows and the chunks are the JAX
        engine's) and the K/V movement strategy resolved
        (``tuning.resolve_sp_strategy``, its autotune key on ``device``)
        or checked."""
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if self.tp > 1:
            if not self.paged:
                raise ValueError(
                    "tensor-parallel serving shards the page pool over "
                    "heads; dense slot mode supports tp=1 only (pass "
                    "paged=True)")
            if cfg.family != "dense":
                raise ValueError(
                    f"tp>1 serving shards attention heads and the dense "
                    f"MLP hidden dim; family {cfg.family!r} is out of "
                    f"scope (expert parallelism is a separate axis)")
            if cfg.num_kv_heads % self.tp:
                raise ValueError(
                    f"GQA kv heads ({cfg.num_kv_heads}) not divisible by "
                    f"tp={self.tp}: each shard must own whole kv heads "
                    f"(with their q-head groups) for collective-free "
                    f"decode attention")
            if cfg.num_heads % self.tp:
                raise ValueError(
                    f"query heads ({cfg.num_heads}) not divisible by "
                    f"tp={self.tp}")
            if cfg.d_ff and cfg.d_ff % self.tp:
                raise ValueError(
                    f"d_ff ({cfg.d_ff}) not divisible by tp={self.tp}")
        self.sp = int(sp)
        if self.sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        self.sp_strategy: str | None = None
        self.sp_prefill_costs = None
        if self.sp > 1:
            if not self.paged:
                raise ValueError(
                    "sequence-parallel prefill shards the packed chunk "
                    "call's query rows; dense slot mode supports sp=1 only "
                    "(pass paged=True)")
            if cfg.family != "dense":
                raise ValueError(
                    f"sp>1 serving runs prefill through the paged chunk "
                    f"step; family {cfg.family!r} is out of scope")
            m = self.sp * io_model.SUBLANES
            self.prefill_bucket += (-self.prefill_bucket) % m
            res = tuning.resolve_sp_strategy(
                chunk_size or self.prefill_bucket, capacity, cfg.head_dim,
                heads_q=cfg.num_heads // self.tp,
                heads_kv=cfg.num_kv_heads // self.tp,
                sp=self.sp, dtype=cfg.dtype, layers=cfg.num_layers,
                device=device)
            self.sp_prefill_costs = res["costs"]
            sp_strategy = sp_strategy or res["strategy"]
            if sp_strategy not in ("allgather", "ring"):
                raise ValueError(
                    f"sp_strategy must be 'allgather' or 'ring', "
                    f"got {sp_strategy!r}")
            self.sp_strategy = sp_strategy

    def _shard(self, model: Model, params, mesh) -> None:
        """The per-shard model view and this rank's params. Without tp or sp
        (and no mesh) the model and params as given."""
        if mesh is None:
            if self.tp > 1 or self.sp > 1:
                raise ValueError(
                    f"tp={self.tp} x sp={self.sp} serving runs one rank a "
                    f"shard over a ServeMesh: pass mesh= "
                    f"(repro_torch.distributed.meshes.serve_mesh)")
            self.mesh = self._mesh = None
            self.shard_model, self.params = model, params
            return
        if (mesh.sp, mesh.tp) != (self.sp, self.tp):
            raise ValueError(f"the mesh is sp={mesh.sp} x tp={mesh.tp}, the "
                             f"engine was asked for sp={self.sp} x "
                             f"tp={self.tp}")
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks run on {mesh.device}, the "
                             f"engine on {self.device}")
        cfg = model.cfg
        self._mesh = mesh
        self.mesh = mesh.counted(self.tm.registry)
        self._c_collectives = self.tm.registry.get("collectives")
        shard_cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.tp,
            num_kv_heads=cfg.num_kv_heads // self.tp,
            d_ff=cfg.d_ff // self.tp, tp_shards=self.tp, sp_shards=self.sp,
            sp_strategy=self.sp_strategy or cfg.sp_strategy)
        self.shard_model = type(model)(shard_cfg, mesh=self.mesh)
        rules = (dist_sharding.sp_serve_rules() if self.sp > 1
                 else dist_sharding.tp_serve_rules())
        self.params = dist_sharding.shard_params(
            params, model.param_specs(), self.mesh, rules)

    def collectives(self) -> dict[str, int]:
        """The mesh's collective calls so far, by kind (all of them: the
        model's and the sp logits gather)."""
        c = self._c_collectives
        return {key[0]: int(c.value(kind=key[0])) for key in c.series_keys()}

    def _census_of(self, call) -> dict[str, int]:
        """The collectives ``call(model)`` runs, by kind: ``model`` is the
        shard model over this rank's mesh counted into a registry of its
        own, so the engine's counters and census stay as they were.
        Every rank must make the call together (its collectives are
        real)."""
        registry = MetricsRegistry()
        model = type(self.shard_model)(self.shard_model.cfg,
                                       mesh=self._mesh.counted(registry))
        with torch.inference_mode():
            call(model)
        c = registry.get("collectives")
        return {key[0]: int(c.value(kind=key[0])) for key in c.series_keys()
                if c.value(kind=key[0])}

    def _placeholder_pool(self):
        """A page pool of one page: the placeholder steps' destinations all
        lie past it (dropped), and their page lists read page 0."""
        return self.shard_model.init_paged_decode_state(
            self.B, 1, self.page_size, self.pages_per_seq,
            device=self.device)

    def decode_collective_census(self) -> dict[str, int]:
        """The collectives one decode step makes, by kind, counted from the
        step itself run on placeholder inputs (a one-page pool whose
        table is unallocated, or a small slot cache; token 0 in every
        lane), which leaves the engine's state and counters as they were:
        ``{"all_reduce": 2 L}`` under tp or sp (the attention's ``wo`` and
        the MLP's ``w_down``; decode is replicated over sp), ``{}``
        unsharded. Callable before the first step; every rank calls it
        together."""
        if self.mesh is None:
            return {}
        tok = torch.zeros((self.B,), dtype=torch.int32, device=self.device)
        if self.paged:
            state = self._placeholder_pool()
        else:
            state = self.shard_model.init_decode_state(
                self.B, min(self.capacity, tuning.DECODE_TILE),
                device=self.device)
        return self._census_of(
            lambda model: model.decode_step(self.params, state, tok))

    def prefill_collective_census(self, kind: str = "chunk"
                                  ) -> dict[str, int]:
        """The collectives one prefill step function makes, by kind,
        counted from the step run on placeholder inputs (all rows padding,
        every write past a one-page pool), the engine's state and counters
        left as they were. Kinds:

        * ``"chunk"``: the paged chunk step (``prefill_chunk_paged``),
          whose contract is ``sharding.expected_sp_prefill_census``: two
          ``all_reduce`` a layer, plus the sp K/V movement;
        * ``"packed"``: the zero-offset packed prefill (sp=1 only; at
          sp > 1 zero chunks run through the chunk step);
        * ``"scatter"``: the packed rows' write into the pool (sp=1 only):
          a data movement, ``{}``.

        ``{}`` unsharded or in dense mode; a ``ValueError`` for "packed" or
        "scatter" at sp > 1 and for an unknown kind. Every rank calls it
        together."""
        if self.mesh is None or not self.paged:
            return {}
        S = self.prefill_bucket
        dev = self.device
        if kind == "chunk":
            Sk = self.chunk_kv_bucket
            Sq = S // self.sp
            pool = self._placeholder_pool()["caches"]
            batch = {
                "tokens": torch.zeros((1, Sq), dtype=torch.int32, device=dev),
                "q_segment_ids": torch.full((1, Sq), SEG_PAD_Q,
                                            dtype=torch.int32, device=dev),
                "q_positions": torch.full((1, Sq), POS_PAD,
                                          dtype=torch.int32, device=dev),
                "kv_segment_ids": torch.zeros((1, Sk), dtype=torch.int32,
                                              device=dev),
                "kv_positions": torch.zeros((1, Sk), dtype=torch.int32,
                                            device=dev),
                "dest_page": torch.ones((S,), dtype=torch.int32, device=dev),
                "dest_off": torch.zeros((S,), dtype=torch.int32, device=dev),
                "page_list": torch.zeros((1, Sk // self.page_size),
                                         dtype=torch.int32, device=dev)}
            return self._census_of(lambda model: model.prefill_chunk_paged(
                self.params, batch, pool))
        if kind == "packed":
            if self.sp > 1:
                raise ValueError(
                    "sp>1 routes zero-offset chunks through the chunk step; "
                    "census kind='chunk' instead")
            batch = {"tokens": torch.zeros((1, S), dtype=torch.int32,
                                           device=dev),
                     "segment_ids": torch.full((1, S), SEG_PAD_Q,
                                               dtype=torch.int32, device=dev)}
            return self._census_of(lambda model: model.prefill_packed(
                self.params, batch))
        if kind == "scatter":
            if self.sp > 1:
                raise ValueError("the packed->pool scatter is an sp=1-only "
                                 "path")
            pool = self._placeholder_pool()["caches"]
            packed = {"kv": {k: t.new_zeros((t.shape[0], 1, t.shape[1], S,
                                             t.shape[4]))
                             for k, t in pool["kv"].items()}}
            dest = torch.ones((S,), dtype=torch.int32, device=dev)
            return self._census_of(lambda model: kvc.scatter_packed_segments(
                pool, packed, dest, torch.zeros_like(dest)))
        raise ValueError(f"unknown prefill census kind {kind!r}")

    def _counted(self, kind: str, call):
        """``call()``, keeping the collectives it ran as ``step_census[kind]``
        when a mesh is active."""
        if self.mesh is None:
            return call()
        before = self.collectives()
        out = call()
        after = self.collectives()
        self.step_census[kind] = {k: n - before.get(k, 0)
                                  for k, n in after.items()
                                  if n != before.get(k, 0)}
        return out

    # --------------------- views over the telemetry registry
    @property
    def prefill_calls(self) -> int:
        return int(self._c_prefill_calls.total())

    @property
    def decode_calls(self) -> int:
        return int(self._c_decode_calls.total())

    @property
    def blocks_skipped(self) -> int:
        return int(self._c_blocks_skipped.total())

    @property
    def blocks_total(self) -> int:
        return int(self._c_blocks_total.total())

    @property
    def last_prefill_layout_density(self) -> float:
        return self._g_layout_density.value(default=1.0)

    @property
    def preemptions(self) -> int:
        return int(self._c_preemptions.total())

    @property
    def peak_active(self) -> int:
        return int(self._g_peak_active.value())

    @property
    def prefix_lookups(self) -> int:
        return int(self._c_prefix_lookups.total())

    @property
    def prefix_hits(self) -> int:
        return int(self._c_prefix_hits.total())

    @property
    def prefix_pages_shared(self) -> int:
        return int(self._c_prefix_pages.total())

    @property
    def prefill_tokens_skipped(self) -> int:
        return int(self._c_tokens_skipped.total())

    @property
    def prefill_hbm_bytes_saved(self) -> int:
        return int(self._c_hbm_saved.total())

    @property
    def prefill_gather_bytes_eliminated(self) -> int:
        return int(self._c_gather_elim.total())

    @property
    def ttfts(self) -> list[float]:
        """Raw TTFT samples (seconds), from the histogram."""
        return self._h_ttft.samples()

    @property
    def tok_latencies(self) -> list[float]:
        """Raw per-token decode latency samples (seconds), from the
        histogram."""
        return self._h_tok.samples()

    @property
    def prefix_cache_hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)

    @property
    def last_step_stats(self) -> dict[str, Any]:
        if not self._stepped:
            return {}
        g = self._g_step
        return {
            "active": int(g["active"].value()),
            "occupancy": g["occupancy"].value(),
            "pool_utilization": (g["pool_utilization"].value()
                                 if self.paged else None),
            "prefill_tokens": int(g["prefill_tokens"].value()),
            "decode_tokens": int(g["decode_tokens"].value()),
            "deferred_chunks": int(g["deferred_chunks"].value()),
            "queued": int(g["queued"].value()),
        }

    # ----------------------------------------------------------------- admit
    def submit(self, prompt: list[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int | None = None) -> int:
        rid = next(self._rid)
        if len(prompt) + 1 > self.capacity:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot decode within "
                f"capacity {self.capacity}")
        if self.paged:
            # the final generated token is emitted but never written back,
            # so the worst-case footprint is prompt + max_new - 1 cache rows.
            worst = self.kv.pages_for(
                min(len(prompt) + max_new_tokens - 1, self.capacity))
            if worst > self.kv.num_pages:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool has "
                    f"{self.kv.num_pages}; enlarge num_pages or shorten "
                    f"the request")
        sp = sampling.SamplingParams(
            temperature=temperature, top_p=top_p,
            seed=rid if seed is None else seed)
        req = Request(rid, list(prompt), max_new_tokens, params=sp,
                      t_submit=time.perf_counter())
        self.requests[rid] = req
        self._stage_prefix(req)
        self.scheduler.submit(rid, len(prompt))
        tr = self.tm.tracer
        if tr.enabled:
            tr.event("req", "submit", rid=rid, prompt_len=len(prompt),
                     max_new=max_new_tokens)
        return rid

    def _stage_prefix(self, req: Request) -> None:
        """Hand the allocator the rolling content hash of the request's
        resume tokens (full pages only), keyed by model identity."""
        if not self.prefix_cache:
            return
        self.kv.stage_prefix(req.rid, kvc.prefix_page_keys(
            self._model_key, req.resume_tokens, self.page_size))

    def _packed_batch(self, reqs: list[Request], lengths: list[int]):
        """Tokens + segment ids for a packed prefill of each request's FIRST
        ``lengths[i]`` resume tokens, padded to the prefill bucket."""
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        total = int(offsets[-1])
        padded = total + (-total) % self.prefill_bucket
        toks = np.zeros((1, padded), np.int32)
        segs = np.full((1, padded), SEG_PAD_Q, np.int32)
        for i, (r, n) in enumerate(zip(reqs, lengths)):
            toks[0, offsets[i]:offsets[i + 1]] = r.resume_tokens[:n]
            segs[0, offsets[i]:offsets[i + 1]] = i
        return toks, segs, offsets

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ----------------------------------------------------------- sampling
    def _sample_rows(self, logits_rows, reqs: list[Request | None]) -> list[int]:
        """One token per row with each request's persisted sampling state;
        counts index the position so preempt->resume replays identically.
        ``None`` rows (idle decode lanes) sample greedy and are discarded."""
        return sampling.sample_tokens(
            logits_rows,
            [r.params.seed if r else 0 for r in reqs],
            [len(r.output) if r else 0 for r in reqs],
            [r.params.temperature if r else 0.0 for r in reqs],
            [r.params.top_p if r else 1.0 for r in reqs])

    # ------------------------------------------------------------- bookkeeping
    def _publish_prefix(self, req: Request, n_rows: int) -> None:
        """Index req's fully-materialized pages (first ``n_rows`` rows are
        written) under their staged content keys — at every chunk boundary,
        so a preempted request has already published its prompt pages."""
        if self.prefix_cache:
            self.kv.publish_prefix(req.rid, n_rows // self.page_size)

    def _finish(self, lane: int, req: Request, reason: str = "stop") -> None:
        req.done = True
        self.finished.append(req)
        tr = self.tm.tracer
        if tr.enabled:
            tr.event("req", "finish", rid=req.rid, reason=reason,
                     tokens=len(req.output))
        if self.paged:
            # publish before release: zero-ref indexed pages are RETAINED.
            self._publish_prefix(req, int(self._kv_len_h[lane]))
        self.scheduler.finish(req.rid)      # frees lane + pages
        self.slot_req[lane] = None
        if self.paged:
            self._kv_len_h[lane] = 0
            self._paged_dirty = True

    def _post_prefill(self, lane: int, req: Request, tok: int) -> None:
        """The final chunk's logits produced the next generated token."""
        if req.t_first is None:
            req.t_first = time.perf_counter()
            self._h_ttft.observe(req.t_first - req.t_submit)
            tr = self.tm.tracer
            if tr.enabled:
                tr.event("req", "first_token", rid=req.rid,
                         ttft_s=req.t_first - req.t_submit)
        req.output.append(tok)
        hit_eos = self.eos_id is not None and tok == self.eos_id
        if hit_eos or len(req.output) >= req.max_new_tokens:
            self._finish(lane, req, "eos" if hit_eos else "max_new_tokens")
            return
        self.next_token[lane] = tok

    def _clear_lane(self, rid: int, lane: int) -> None:
        """Clear an evicted sequence's lane — only if the lane still holds
        it (a lane may have been handed to a new admission already)."""
        if self.slot_req[lane] is self.requests[rid]:
            self.slot_req[lane] = None
            if self.paged:
                self._kv_len_h[lane] = 0

    def _sync_evictions(self, plan) -> None:
        """Translate scheduler evictions into Request outcomes: requeue at
        the front with the generated prefix, or finish at capacity."""
        tr = self.tm.tracer
        for rid, lane in plan.finished_capacity:
            req = self.requests[rid]
            self._clear_lane(rid, lane)
            req.done = True
            self.finished.append(req)
            if tr.enabled:
                tr.event("req", "finish", rid=rid, reason="capacity",
                         tokens=len(req.output))
        for rid, lane in plan.preempted:
            req = self.requests[rid]
            self._clear_lane(rid, lane)
            self._preempted_rids.add(rid)
            if tr.enabled:
                tr.event("req", "preempt", rid=rid,
                         reason=plan.preempt_reasons.get(rid, ""),
                         generated=len(req.output))
            if len(req.resume_tokens) > self.capacity:
                req.done = True
                self.finished.append(req)
                if tr.enabled:
                    tr.event("req", "finish", rid=rid, reason="capacity",
                             tokens=len(req.output))
                continue
            self._stage_prefix(req)     # release dropped the staged keys
            self.scheduler.resubmit_front(rid, len(req.resume_tokens))
            self._c_preemptions.inc()
        if plan.dirty and self.paged:
            self._paged_dirty = True

    # ----------------------------------------- executor: zero-offset prefill
    def _exec_zero_paged(self, tasks: list[ChunkTask]) -> None:
        """Chunks starting at logical position 0 attend nothing before
        themselves: ONE packed self-attention prefill, then one in-place
        write of its K/V rows into pool pages."""
        t_w = time.perf_counter()
        reqs = [self.requests[t.rid] for t in tasks]
        lengths = [t.length for t in tasks]
        toks, segs, offsets = self._packed_batch(reqs, lengths)
        caches, logits = self._counted(
            "prefill_zero", lambda: self.shard_model.prefill_packed(
                self.params, {"tokens": self._dev(toks),
                              "segment_ids": self._dev(segs)}))
        self._c_prefill_calls.inc()
        self._record_layout_stats(segs)
        tables = [self.kv.table(t.rid) for t in tasks]
        dest_page, dest_off = kvc.packed_destinations(
            tables, offsets, lengths, self.page_size, toks.shape[1],
            self.kv.num_pages)
        kvc.scatter_packed_segments(self.state["caches"], caches,
                                    self._dev(dest_page), self._dev(dest_off))
        self._paged_dirty = True
        for i, t in enumerate(tasks):
            self._kv_len_h[t.lane] = t.length
            self._publish_prefix(reqs[i], t.length)
        self._emit_first_tokens(tasks, logits, offsets)
        self._account_prefill("prefill_zero", tasks,
                              time.perf_counter() - t_w)

    def _emit_first_tokens(self, tasks, logits, offsets) -> None:
        """Sample the next token of every task whose chunk completes its
        prefill (the chunk's last-row logits)."""
        lasts = [(i, t) for i, t in enumerate(tasks) if t.last]
        if not lasts:
            return
        rows = [int(offsets[i]) + t.length - 1 for i, t in lasts]
        toks = self._sample_rows(self._rows_of(logits, rows),
                                 [self.requests[t.rid] for _, t in lasts])
        for (_, t), tok in zip(lasts, toks):
            self._post_prefill(t.lane, self.requests[t.rid], int(tok))

    def _rows_of(self, logits, rows: list[int]):
        """``logits[0, rows]`` of the packed call. At sp > 1 each rank holds
        only its slab of the rows: each row comes from the rank that owns
        it, through one ``all_gather`` over the sp group (the others send
        zeros in its place)."""
        if self.sp == 1:
            return logits[0, torch.as_tensor(rows, device=logits.device)]
        slab = logits.shape[1]
        mine = self.mesh.sp_group.index
        part = logits.new_zeros((1, len(rows), logits.shape[2]))
        for j, r in enumerate(rows):
            if r // slab == mine:
                part[0, j] = logits[0, r % slab]
        every = comm.all_gather(part, self.mesh.sp_group, dim=0)
        return every[[r // slab for r in rows], list(range(len(rows)))]

    # -------------------------------------------- executor: suffix chunks
    def _kv_bucketed(self, width: int) -> int:
        """Round the packed kv width UP to the bucket multiple (never
        capped: several segments' prefixes can sum past one capacity)."""
        b = max(1, self.chunk_kv_bucket)
        return width + (-width) % b

    def _exec_suffix_paged(self, tasks: list[ChunkTask]) -> None:
        """Chunks with history run as ONE packed varlen call against the
        page pool: write each chunk's K/V rows into its pages, then attend
        each sequence's full logical prefix IN PLACE through a page list
        (``kv_cache.paged_prefix_lists``) with per-segment positions."""
        t_w = time.perf_counter()
        reqs = [self.requests[t.rid] for t in tasks]
        lengths = [t.length for t in tasks]
        starts = [t.start for t in tasks]
        q_off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        total_q = int(q_off[-1])
        Sq = total_q + (-total_q) % self.prefill_bucket
        toks = np.zeros((1, Sq), np.int32)
        qseg = np.full((1, Sq), SEG_PAD_Q, np.int32)
        qpos = np.full((1, Sq), POS_PAD, np.int32)
        for i, (r, st, n) in enumerate(zip(reqs, starts, lengths)):
            sl = slice(int(q_off[i]), int(q_off[i + 1]))
            toks[0, sl] = r.resume_tokens[st:st + n]
            qseg[0, sl] = i
            qpos[0, sl] = np.arange(st, st + n)

        spans = [st + n for st, n in zip(starts, lengths)]
        tables = [self.kv.table(t.rid) for t in tasks]
        dest_page, dest_off = kvc.chunk_destinations(
            tables, starts, q_off, lengths, self.page_size, Sq,
            self.kv.num_pages)
        pages_needed = sum(kvc.pages_for(sp, self.page_size) for sp in spans)
        Sk = self._kv_bucketed(pages_needed * self.page_size)
        page_list, kseg, kpos = kvc.paged_prefix_lists(
            tables, spans, self.page_size, Sk // self.page_size)
        cfg = self.model.cfg
        self._c_gather_elim.inc(int(sum(
            io_model.gather_hbm_bytes(sp, cfg.head_dim, cfg.num_kv_heads,
                                      elt=tuning.elt_bytes(cfg.dtype),
                                      layers=cfg.num_layers)
            for sp in spans)))
        if self.sp > 1:
            # this rank's slab of the q rows; the kv side stays whole
            slab = Sq // self.sp
            mine = slice(self.mesh.sp_group.index * slab,
                         (self.mesh.sp_group.index + 1) * slab)
            toks, qseg, qpos = toks[:, mine], qseg[:, mine], qpos[:, mine]
        batch = {"tokens": self._dev(toks),
                 "q_segment_ids": self._dev(qseg),
                 "q_positions": self._dev(qpos),
                 "kv_segment_ids": self._dev(kseg[None]),
                 "kv_positions": self._dev(kpos[None]),
                 "dest_page": self._dev(dest_page),
                 "dest_off": self._dev(dest_off),
                 "page_list": self._dev(page_list[None])}
        _, logits = self._counted(
            "prefill_chunk", lambda: self.shard_model.prefill_chunk_paged(
                self.params, batch, self.state["caches"]))
        self._c_prefill_calls.inc()
        self._paged_dirty = True
        for t, r in zip(tasks, reqs):
            self._kv_len_h[t.lane] = t.start + t.length
            self._publish_prefix(r, t.start + t.length)
        self._emit_first_tokens(tasks, logits, q_off)
        self._account_prefill("prefill_chunk", tasks,
                              time.perf_counter() - t_w)

    # ----------------------------------------------- executor: dense prefill
    def _exec_dense(self, tasks: list[ChunkTask]) -> None:
        """Dense mode is atomic-only: every task covers its whole prompt.
        Several drained requests prefill in ONE packed call."""
        t_w = time.perf_counter()
        reqs = [self.requests[t.rid] for t in tasks]
        if self.packed_prefill and len(tasks) > 1:
            self._admit_packed(tasks, reqs)
        else:
            for t, req in zip(tasks, reqs):
                self._admit_one(t, req)
        self._account_prefill("prefill_dense", tasks,
                              time.perf_counter() - t_w)

    def _bucketed(self, length: int) -> int:
        """Pad a prefill length to the bucket multiple (capped at
        capacity)."""
        bucket = max(1, min(self.prefill_bucket, self.capacity))
        return min(length + (-length) % bucket, self.capacity)

    def _insert_segment(self, packed_caches, slot: int, offset: int,
                        length: int, kv_len_new: int) -> None:
        """Copy packed rows [offset, offset + length) of every layer's K/V
        into slot rows [0, length), in place, and record the slot's valid
        length. Cache leaves are (L, B, hkv, capacity, hd); packed leaves
        (L, 1, hkv, S, hd)."""
        for name, big in self.state["caches"]["kv"].items():
            small = packed_caches["kv"][name]
            big[:, slot, :, :length] = small[:, 0, :, offset:offset + length]
        self.state["kv_len"][slot] = kv_len_new

    def _insert(self, slot_caches, slot: int, kv_len_new: int) -> None:
        """Overwrite slot ``slot``'s WHOLE state, every cache leaf, with a
        batch-1 ``Model.prefill``'s state (leaves (L, 1, ...)), in place: a
        leaf the prefill filled only in part (a conv state of fewer than
        w-1 rows, from a prompt that short) is zero past it, so nothing of
        the slot's last occupant, or of its idle decode steps, is left."""
        def ins(big, small):
            dst = big[:, slot]
            dst.zero_()
            dst[(slice(None),) + tuple(slice(0, n)
                                       for n in small.shape[2:])] = small[:, 0]

        tree_map(ins, self.state["caches"], slot_caches)
        self.state["kv_len"][slot] = kv_len_new

    def _admit_one(self, task: ChunkTask, req: Request) -> None:
        """One batch-1 prefill into the task's slot: padded to the prefill
        bucket for the packable families; unpadded, through
        ``Model.prefill``, for those with recurrent state."""
        toks = req.resume_tokens
        L = len(toks)
        if not self.model.supports_packed_prefill():
            slot_state, logits = self.shard_model.prefill(
                self.params, {"tokens": self._dev(np.asarray([toks],
                                                             np.int32))},
                self.capacity)
            self._c_prefill_calls.inc()
            self._insert(slot_state["caches"], task.lane, L)
            tok = self._sample_rows(logits[0, -1][None], [req])[0]
            self._post_prefill(task.lane, req, int(tok))
            return
        padded = self._bucketed(L)
        arr = np.zeros((1, padded), np.int32)
        arr[0, :L] = toks
        segs = np.full((1, padded), SEG_PAD_Q, np.int32)
        segs[0, :L] = 0
        caches, logits = self.shard_model.prefill_packed(
            self.params, {"tokens": self._dev(arr),
                          "segment_ids": self._dev(segs)})
        self._c_prefill_calls.inc()
        self._insert_segment(caches, task.lane, 0, padded, L)
        tok = self._sample_rows(logits[0, L - 1][None], [req])[0]
        self._post_prefill(task.lane, req, int(tok))

    def _admit_packed(self, tasks: list[ChunkTask],
                      reqs: list[Request]) -> None:
        """ONE (1, ΣLᵢ) prefill for all drained requests, then each
        segment's rows into its slot."""
        lengths = [len(r.resume_tokens) for r in reqs]
        toks, segs, offsets = self._packed_batch(reqs, lengths)
        caches, logits = self.shard_model.prefill_packed(
            self.params, {"tokens": self._dev(toks),
                          "segment_ids": self._dev(segs)})
        self._c_prefill_calls.inc()
        self._record_layout_stats(segs)
        for i, t in enumerate(tasks):
            self._insert_segment(caches, t.lane, int(offsets[i]), lengths[i],
                                 lengths[i])
        self._emit_first_tokens(tasks, logits, offsets)

    def _record_layout_stats(self, segs: np.ndarray) -> None:
        """Compile the packed call's causal + segment layout on the host and
        count the blocks it proves skippable (cross-document and
        padded-tail tiles the causal geometry alone would run), at the q
        tile of the analytic chooser (a counter never triggers a timing
        run) capped by the prefill bucket."""
        s = segs.shape[1]
        cfg = self.model.cfg
        report_block = (cfg.attn_block_q if cfg.attn_block_q is not None
                        else tuning.choose_tile_config(
                            s, s, cfg.head_dim, dtype=cfg.dtype,
                            shards=self.tp).block_q)
        bq = min(report_block, self.prefill_bucket, s)
        if s % bq:
            return  # bucket not block-aligned; skip the report, not the call
        ids = torch.as_tensor(segs)
        layout = masks.compile_block_layout(
            masks.MaskSpec(causal=True, q_segment_ids=ids,
                           kv_segment_ids=ids), s, s, bq, bq).as_array()
        skipped = int((layout == masks.BLOCK_SKIP).sum())
        total = layout.numel()
        self._c_blocks_skipped.inc(skipped)
        self._c_blocks_total.inc(total)
        self._g_layout_density.set(1.0 - skipped / total)

    # ------------------------------------------------------ executor: decode
    def _exec_decode(self, decode_lanes: list[int]) -> None:
        lanes = [l for l in decode_lanes if self.slot_req[l] is not None]
        if not lanes:
            return
        # pre-step KV lengths price the split-KV reads (ledger, below)
        kv_lens = [self.scheduler.by_rid[self.slot_req[l].rid].filled
                   for l in lanes]
        if self.paged and self._paged_dirty:
            # upload the host allocator's view only when it changed. Lanes
            # still PREFILLING get -1 rows: the decode write drops their
            # rows and the mask IR classifies their pages SKIP.
            lane_set = set(lanes)
            row_rids = [
                (self.slot_req[l].rid
                 if l in lane_set and self.slot_req[l] is not None else None)
                for l in range(self.B)]
            self.state["page_table"] = self._dev(
                self.kv.table_array(row_rids, self.pages_per_seq))
            self.state["kv_len"] = self._dev(self._kv_len_h.astype(np.int32))
            self._paged_dirty = False
        t0 = time.perf_counter()
        tok = self._dev(self.next_token)
        reqs_by_lane = [self.slot_req[l] for l in range(self.B)]
        self.state, logits = self._counted(
            "decode", lambda: self.shard_model.decode_step(
                self.params, self.state, tok))
        self._c_decode_calls.inc()
        nxt = self._sample_rows(logits[:, 0], reqs_by_lane)
        # sampling brought the tokens to the host, so the step's device
        # work is done: one wall-clock sample covers every token here.
        dt = time.perf_counter() - t0
        for _ in lanes:
            self._h_tok.observe(dt)
        hbm = self.tm.ledger.price.decode_bytes(kv_lens)
        self.tm.ledger.account("decode", hbm_bytes=hbm, wall_s=dt,
                               tokens=len(lanes))
        tr = self.tm.tracer
        if tr.enabled:
            tr.span("step", "decode", tr.now() - dt, dt,
                    step=self._step_idx, lanes=list(lanes),
                    tokens=len(lanes), kv_rows=int(sum(kv_lens)),
                    hbm_bytes=hbm, tiles=self._tile_args())
        for lane in lanes:
            req = self.slot_req[lane]
            t = int(nxt[lane])
            req.output.append(t)
            self.next_token[lane] = t
            self.scheduler.token_appended(req.rid)
            if self.paged:
                self._kv_len_h[lane] += 1
            hit_eos = self.eos_id is not None and t == self.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos:
                self._finish(lane, req,
                             "eos" if hit_eos else "max_new_tokens")

    # ------------------------------------- telemetry accounting helpers
    def _account_prefill(self, name: str, tasks: list[ChunkTask],
                         dt: float) -> None:
        """IO-ledger + trace bookkeeping for one executed prefill call."""
        spans = [(t.start, t.length) for t in tasks]
        tokens = sum(t.length for t in tasks)
        hbm = self.tm.ledger.price.prefill_bytes(spans)
        self.tm.ledger.account(name, hbm_bytes=hbm, wall_s=dt,
                               tokens=tokens)
        tr = self.tm.tracer
        if not tr.enabled:
            return
        tr.span("step", name, tr.now() - dt, dt, step=self._step_idx,
                lanes=[t.lane for t in tasks],
                chunks=[[t.start, t.length] for t in tasks],
                tokens=tokens, hbm_bytes=hbm, tiles=self._tile_args())
        for t in tasks:
            tr.event("req", "chunk", rid=t.rid, lane=t.lane,
                     start=t.start, length=t.length, last=t.last)

    def _tile_args(self) -> dict[str, Any]:
        """The priced tile geometry (and the decode's) for span args."""
        p = self.tm.ledger.price
        out: dict[str, Any] = {"block_q": p.block_q, "block_k": p.block_k,
                               "kv_major": p.kv_major}
        if hasattr(self, "decode_block_k"):
            out["decode_block_k"] = self.decode_block_k
        if hasattr(self, "num_decode_splits"):
            out["num_decode_splits"] = self.num_decode_splits
        return out

    # ------------------------------------------------------------------ step
    @torch.inference_mode()
    def step(self) -> None:
        t_step = time.perf_counter()
        self._step_idx += 1
        plan = self.scheduler.plan_step()
        # evictions FIRST (they clear lanes admissions may reuse); a request
        # both admitted and starve-evicted in this plan is never placed.
        self._sync_evictions(plan)
        evicted = ({rid for rid, _ in plan.preempted}
                   | {rid for rid, _ in plan.finished_capacity})
        tr = self.tm.tracer
        for rid, lane in plan.admitted:
            if rid not in evicted:
                self.slot_req[lane] = self.requests[rid]
                self._record_prefix_hit(rid)
                if tr.enabled:
                    tr.event("req",
                             "resume" if rid in self._preempted_rids
                             else "admit",
                             rid=rid, lane=lane,
                             cached=self.scheduler.by_rid[rid].cached)

        zero = [t for t in plan.prefill if t.start == 0]
        suffix = [t for t in plan.prefill if t.start > 0]
        if not self.paged:
            if zero:
                self._exec_dense(zero)
        elif self.sp > 1:
            # the chunk step is exact at start 0 and carries the sp slabs;
            # the packed prefill + scatter pair is an sp=1 path
            if plan.prefill:
                self._exec_suffix_paged(list(plan.prefill))
        else:
            if zero:
                if self.packed_prefill and len(zero) > 1:
                    self._exec_zero_paged(zero)
                else:
                    for t in zero:
                        self._exec_zero_paged([t])
            if suffix:
                self._exec_suffix_paged(suffix)

        active = sum(r is not None for r in self.slot_req)
        self._g_peak_active.max_update(active)
        g = self._g_step
        g["active"].set(active)
        g["occupancy"].set(active / self.B)
        if self.paged:
            g["pool_utilization"].set(self.kv.utilization())
        g["prefill_tokens"].set(sum(t.length for t in plan.prefill))
        g["decode_tokens"].set(len(plan.decode_lanes))
        g["deferred_chunks"].set(plan.deferred_chunks)
        g["queued"].set(len(self.scheduler.queue))
        self._stepped = True
        self._exec_decode(plan.decode_lanes)
        g["queued"].set(len(self.scheduler.queue))
        if tr.enabled:
            dt = time.perf_counter() - t_step
            tr.span("stepsum", "step", tr.now() - dt, dt,
                    step=self._step_idx, **self.last_step_stats)

    def run(self, max_steps: int = 10_000, on_step=None) -> list[Request]:
        """Drive the engine to drain; ``on_step(engine)`` after every step."""
        for _ in range(max_steps):
            if self.scheduler.idle():
                break
            self.step()
            if on_step is not None:
                on_step(self)
        return self.finished

    # --------------------------------------------------------- observability
    def _record_prefix_hit(self, rid: int) -> None:
        """Account one admission's prefix-cache outcome: rows the scheduler
        mapped from shared pages are prefill that never runs, credited in
        HBM bytes (``io_model.prefix_cache_hbm_bytes_saved``)."""
        if not self.prefix_cache:
            return
        self._c_prefix_lookups.inc()
        cached = self.scheduler.by_rid[rid].cached
        if not cached:
            return
        self._c_prefix_hits.inc()
        self._c_prefix_pages.inc(cached // self.page_size)
        self._c_tokens_skipped.inc(cached)
        cfg = self.model.cfg
        saved = int(io_model.prefix_cache_hbm_bytes_saved(
            cached, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
            elt=tuning.elt_bytes(cfg.dtype), layers=cfg.num_layers))
        self._c_hbm_saved.inc(saved)
        # prefix hits are bytes NOT spent: the ledger carries them as a
        # separate credit kind, never summed into total_bytes().
        self.tm.ledger.account("prefix_saved", hbm_bytes=saved,
                               tokens=cached)
        tr = self.tm.tracer
        if tr.enabled:
            tr.event("req", "prefix_hit", rid=rid, cached_tokens=cached,
                     pages=cached // self.page_size, hbm_bytes_saved=saved)

    @staticmethod
    def step_stats_printer():
        """``run(on_step=...)`` callback printing per-step batch occupancy
        and page-pool utilization."""
        counter = itertools.count(1)

        def show(e):
            s = e.last_step_stats
            util = (f" pool {s['pool_utilization']:.0%}"
                    if s["pool_utilization"] is not None else "")
            work = ""
            if s.get("prefill_tokens"):
                work = (f" prefill {s['prefill_tokens']}t"
                        f"+decode {s['decode_tokens']}t")
            print(f"  step {next(counter):>3}: batch {s['active']}/{e.B} "
                  f"({s['occupancy']:.0%}){util}{work} queued {s['queued']}")

        return show

    def cache_bytes(self) -> int:
        """Device bytes resident in the decode state's caches (page pool or
        slot cache, and the SSM state where the family has one), summed
        over all shards, as the reference's global ``nbytes``: this
        rank's times tp (the pool is cut over tp by heads and replicated
        over sp)."""
        return self.per_shard_cache_bytes() * self.tp

    def per_shard_cache_bytes(self) -> int:
        """This rank's device bytes of the decode state's caches: its pool
        holds ``num_kv_heads / tp`` heads of every page."""
        return int(sum(t.numel() * t.element_size()
                       for t in tree_leaves(self.state["caches"])))

    @property
    def queue(self) -> list[Request]:
        """Pending (not yet admitted) requests, in service order."""
        return [self.requests[rid] for rid, _ in self.scheduler.queue]

    def latency_stats(self) -> dict[str, float]:
        """Percentile-reduced per-request latencies (seconds): TTFT (submit
        -> first generated token) and per-token decode step latency."""
        out: dict[str, float] = {}
        for name, h in (("ttft", self._h_ttft),
                        ("tok_latency", self._h_tok)):
            for q in (50, 95):
                out[f"{name}_p{q}"] = h.percentile(q)
        return out
