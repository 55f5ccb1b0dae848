"""IO-aware tile choice for the Hopper attention kernels (port of
``repro.kernels.tuning``): every tile size is a resolved decision.

The paper derives its block sizes from the SRAM budget M (Alg. 1 line 1:
``B_c = ceil(M/4d)``). This module is the single audited decision point
the attention ops, the decode wrappers, the serving engine and the
launchers resolve through, with the reference's names, cache keys and
cache file, over the tiles the CUDA bodies take:

* ``TileConfig`` — one record of every tile-shaped choice a call makes:
  training/prefill ``(block_q, block_k)``, decode ``(decode_block_k,
  num_decode_splits)``, the accumulator ``variant``, the loop order
  (``kv_major``: always False here, the Hopper bodies walk q-major) and
  the sequence-parallel strategy.
* ``choose_tile_config`` — the ANALYTIC chooser: among the card's legal
  tiles (multiples of ``ROW_ALIGN`` rows up to ``MAX_TILE``), those whose
  shared memory (``core.io_model.attention_working_set_bytes``: the
  forward's block, or the largest of the forward and the two backward
  blocks) fits the budget, ranked by the Theorem-2 HBM bytes
  (``core.io_model.flash_hbm_bytes_tiled``), with the reference's
  ``TARGET_GRID_CELLS`` rule for tensor-parallel shards. Pure arithmetic,
  memoized; with the default budget and one shard it picks
  ``(round_block(64, sq), round_block(64, sk))`` at every shape.
* ``autotune_tiles`` / ``autotune_decode_geometry`` — the optional
  EMPIRICAL refinement: times candidates on the device (CUDA events on the
  card, the plain versions under ``time.perf_counter`` on the CPU) and
  persists the winner in a JSON cache (``AutotuneCache``, the reference's
  schema) keyed by ``(device kind, dtype, head_dim, seq bucket, mask
  class)``, with a per-kind calibration of the IO model against the
  clock.
* ``resolve_tiles`` / ``resolve_decode_geometry`` / ``resolve_sp_strategy``
  — what the callers call. ``None`` means auto (empirical when
  ``configure_tuning(autotune=True)``, analytic otherwise); explicit
  values pass through (and are still validated).

Also the kernels' fixed limits: ``round_block``, ``sparse_tile`` (an
Alg. 5 pattern's block cut into kernel tiles), ``fwd_tiles`` /
``bwd_tiles`` (the largest tiles, ``MAX_TILE`` x ``MAX_TILE``, which fit
a block at every head_dim the kernels take), ``fwd_pages_per_tile`` /
``check_page_size`` (the pages one paged kv tile gathers),
``fwd_kv_groups``, ``decode_split_target`` and ``check_decode_splits``
(the decode merges its splits in one thread-block cluster of at most
``MAX_DECODE_SPLITS`` blocks), ``sm90_bwd_rows`` (the CTA tile of the
wgmma backward pair, by the shape's grid) and ``sm90_fwd_rows`` /
``sm90_fwd_splits`` (the wgmma forward's CTA tile and the cluster a long
kv walk of a small grid is split over).

Paged invariant: the page is the mask IR's kv block and the unit of cache
allocation, so for paged decode the tuner does not choose the kv block —
it takes ``page_size`` or rejects an explicit conflicting ``block_k``.

``python -m repro_torch.kernels.tuning --smoke [--device cuda|cpu]`` runs
the autotune write + read round trip; run twice, the second time with
``--expect-hit``, the second run must be served from the cache.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import json
import os
import time
from typing import Any

from repro_torch.core import io_model
from repro_torch.core.io_model import H100_SMEM_PER_BLOCK as SMEM_PER_BLOCK
from repro_torch.core.io_model import MAX_TILE  # csrc/flash_fwd.cu MAX_BQ / MAX_BK
from repro_torch.core.io_model import (attention_working_set_bytes,
                                       bwd_smem_bytes, fwd_kv_groups,
                                       fwd_smem_bytes)
from repro_torch.telemetry.metrics import default_registry

LANES = 128                 # the reference's TPU lane count: the smallest
                            # sequence bucket (``seq_bucket``)
ROW_ALIGN = 8               # tile rows: multiple of 8 (one mma.sync m-tile)
SUBLANES = ROW_ALIGN        # the reference's name for the row alignment
MAX_BLOCK = MAX_TILE        # the largest tile the bodies take
PAGE_SIZES = (8, 16, 32, 64)    # pages the paged kernels take on the card
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
TARGET_DECODE_SPLITS = 8    # split-KV parallelism target
MAX_DECODE_SPLITS = 8       # csrc/flash_decode.cu MAX_SPLITS: portable cluster size
DECODE_TILE = 64            # csrc/flash_decode.cu TILE: kv rows of one ring stage
TARGET_GRID_CELLS = 8       # per-device (head, q-block) cells a sharded
                            # call should keep busy: with heads/tp local
                            # heads, block_q shrinks to recover grid
                            # parallelism lost to the head shard
TIMED_TILES = (64, 32, 16)  # the autotuner's timed tile heights: the mma
                            # bodies pad any other tile to a multiple of 16
TIMED_REPS = 20             # back-to-back calls in one timed sample (card)

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2, "float16": 2,
    "f16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def _dtype_name(dtype: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ... for a torch dtype, a numpy dtype
    or a name: the reference's names, so that cache keys are equal."""
    try:
        import numpy as np
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype).removeprefix("torch.")


def elt_bytes(dtype: Any) -> int:
    """Bytes of one element of a dtype (``"bfloat16"`` 2, ``"float32"``
    4), as the reference's ``tuning._elt_bytes``."""
    return _DTYPE_BYTES.get(_dtype_name(dtype), 4)


# ---------------------------------------------------------------------------
# TileConfig — the resolved decision record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Every tile-shaped decision one attention call site makes (the
    reference's record, field for field). ``kv_major`` is always False:
    the Hopper bodies walk q-major, and a cache entry written by the
    reference with True still loads. ``sp_strategy`` records the
    sequence-parallel K/V movement ("allgather" | "ring") of entries
    resolved by ``resolve_sp_strategy`` under ``|spN`` (None elsewhere).
    ``source`` is observability only: "explicit", "analytic", "cache" or
    "autotuned"."""
    block_q: int
    block_k: int
    decode_block_k: int | None = None
    num_decode_splits: int | None = None
    variant: str = "fa2"
    kv_major: bool = False
    sp_strategy: str | None = None
    source: str = "analytic"

    def as_cache_entry(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("source")
        return d

    @classmethod
    def from_cache_entry(cls, entry: dict) -> "TileConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in entry.items() if k in fields},
                   source="cache")


# ---------------------------------------------------------------------------
# Tuner-wide knobs (launchers: --autotune / --sram-budget)
# ---------------------------------------------------------------------------

_DEFAULT_CACHE = os.environ.get(
    "REPRO_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                 "autotune.json"))

_STATE: dict[str, Any] = {
    "sram_budget": int(os.environ["REPRO_SRAM_BUDGET"])
    if "REPRO_SRAM_BUDGET" in os.environ else None,
    "autotune": os.environ.get("REPRO_AUTOTUNE", "") == "1",
    "cache_path": _DEFAULT_CACHE,
}


def configure_tuning(*, sram_budget: int | None = None,
                     autotune: bool | None = None,
                     cache_path: str | None = None) -> None:
    """Process-wide tuner knobs (the launchers call this from their flags).
    ``None`` leaves a knob unchanged; the analytic memo is dropped so a new
    budget takes effect at once."""
    if sram_budget is not None:
        _STATE["sram_budget"] = int(sram_budget)
    if autotune is not None:
        _STATE["autotune"] = bool(autotune)
    if cache_path is not None:
        _STATE["cache_path"] = cache_path
        global _CACHE
        _CACHE = None
    _analytic_choice.cache_clear()


def sram_budget() -> int:
    """Shared-memory bytes a tile may take (default
    ``io_model.DEFAULT_SRAM_BUDGET``: one Hopper block's)."""
    b = _STATE["sram_budget"]
    return io_model.DEFAULT_SRAM_BUDGET if b is None else int(b)


def autotune_enabled() -> bool:
    return bool(_STATE["autotune"])


# ---------------------------------------------------------------------------
# The kernels' fixed limits
# ---------------------------------------------------------------------------

def round_block(requested: int, seq_len: int) -> int:
    """Clamp a block size to a sequence WITHOUT producing an unaligned
    tile: cap at the sequence rounded UP to ``ROW_ALIGN`` (the caller pads
    the operand to a block multiple) and round down to ``ROW_ALIGN``,
    floor ``ROW_ALIGN``. A block below one row raises."""
    if int(requested) < 1:
        raise ValueError(f"a tile of {requested} rows: pass a positive "
                         f"block or None (auto)")
    cap = -(-max(seq_len, 1) // ROW_ALIGN) * ROW_ALIGN
    blk = min(int(requested), cap)
    blk = max(ROW_ALIGN, (blk // ROW_ALIGN) * ROW_ALIGN)
    return min(blk, cap)


def _aligned_candidates(seq_len: int) -> list[int]:
    """Descending tile heights the card takes for one axis: multiples of
    ``ROW_ALIGN`` from the sequence rounded up to ``ROW_ALIGN``, capped at
    ``MAX_TILE`` (the reference's sublane branch; its lane multiples of
    128 rows are tiles the bodies refuse)."""
    cap = min(MAX_TILE, -(-max(seq_len, 1) // ROW_ALIGN) * ROW_ALIGN)
    return list(range(cap, 0, -ROW_ALIGN))


def sparse_tile(block: int, on_card: bool) -> tuple[int, int]:
    """(tile, factor) for one axis of a block-sparse pattern (paper Alg. 5)
    whose grid fixes the block: a block of at most ``MAX_TILE`` rows is the
    tile (factor 1); a multiple of ``MAX_TILE`` is cut into ``factor``
    tiles of ``MAX_TILE`` (the pattern refined exactly,
    ``masks.refine_block_layout``). Any other block raises on the card,
    whose kernels take tiles of at most ``MAX_TILE`` rows; the plain
    versions on the CPU take it as it is."""
    if block <= MAX_TILE:
        return block, 1
    if block % MAX_TILE == 0:
        return MAX_TILE, block // MAX_TILE
    if on_card:
        raise ValueError(
            f"a block-sparse layout's block of {block} rows is neither at "
            f"most {MAX_TILE} nor a multiple of {MAX_TILE}: the kernels "
            f"take tiles of at most {MAX_TILE} rows, and only a multiple "
            f"refines into them exactly")
    return block, 1


def fwd_tiles(head_dim: int) -> tuple[int, int]:
    """The largest (block_q, block_k) the forward takes, the tiles the
    analytic chooser picks wherever a sequence spans them: 64 x 64 fits
    shared memory for every head_dim the kernel takes (115 KB fp32, 84 KB
    bf16, 152 KB bf16 paged at d = 128; 90 KB, 63 KB and 115 KB at d =
    96)."""
    bq = bk = MAX_TILE
    for bf16, paged in ((False, False), (True, False), (True, True)):
        assert attention_working_set_bytes(
            bq, bk, max(KERNEL_HEAD_DIMS), bf16=bf16, paged=paged,
            backward=False) <= SMEM_PER_BLOCK
    return bq, bk


def bwd_tiles(head_dim: int) -> tuple[int, int]:
    """The largest backward (block_q, block_k) for a head_dim: the
    forward's, because one tile choice serves the forward and the backward
    (``ops.flash_attention``); 64 x 64 fits shared memory for every
    head_dim the kernels take (fp32 166 KB, bf16 101 KB contiguous and
    168 KB paged at d = 128)."""
    bq, bk = fwd_tiles(head_dim)
    for bf16, paged in ((False, False), (True, False), (True, True)):
        if attention_working_set_bytes(bq, bk, head_dim, bf16=bf16,
                                       paged=paged) > SMEM_PER_BLOCK:
            raise ValueError(f"backward tiles ({bq}, {bk}) exceed shared "
                             f"memory at head_dim {head_dim}")
    return bq, bk


def fwd_pages_per_tile(page_size: int) -> int:
    """Pages one kv tile of the paged forward gathers: a tile is
    ``MAX_TILE`` keys of whole pages, so the page must divide it (8, 16,
    32 or 64 rows). Any other page size raises (``check_page_size``): the
    kernel takes no other, and there is no fallback."""
    return MAX_TILE // check_page_size(page_size)


def check_page_size(page_size: int) -> int:
    """The page sizes the paged kernels take on the card: the paged
    forward (``flash_fwd_paged``) and the bf16 paged backward
    (``flash_bwd_dq_paged``, ``flash_bwd_dkv_paged``) and paged decode
    (``flash_decode_paged``) gather ``MAX_TILE // page_size`` whole pages
    into one kv tile, so a page is 8, 16, 32 or 64 rows. A paged
    ``ServingEngine`` on the card calls this at construction, so that
    another page size raises there and not mid-serve; the plain versions
    on the CPU take any page size. Returns the page size."""
    if page_size not in PAGE_SIZES:
        raise ValueError(
            f"the paged kernels (flash_fwd_paged, flash_bwd_dq_paged, "
            f"flash_bwd_dkv_paged, flash_decode_paged) take page sizes "
            f"{PAGE_SIZES} on the card, got {page_size}")
    return page_size


H100_SMS = 132              # streaming multiprocessors of an H100 SXM
SM90_BWD_HEAD_DIMS = (64, 96, 128)   # csrc/flash_bwd_sm90.cu's head dims
SM90_MAX_WALK = 2048        # csrc/flash_bwd_sm90.cu MAX_WALK: layout blocks
                            # of one row or column


def sm90_bwd_rows(batch: int, heads: int, blocks: int,
                  num_sms: int = H100_SMS, *, kernel: str = "dq",
                  head_dim: int = 64) -> int:
    """The CTA tile of the sm90 backward pair (``csrc/flash_bwd_sm90.cu``)
    in rows: dq passes (b, hq, nq), dkv (b, hkv, nk), nq and nk in 64-row
    layout blocks (the paged pair: dq (b, hq, nq), dkv (b, hkv, 64-key page
    groups, ``ceil(T * page / 64)``)). 128 (two layout blocks, one per consumer warpgroup,
    both reading every stage of the ring) where that grid, ``batch * heads
    * ceil(blocks / 2)`` CTAs of one per SM, still gives every SM a CTA;
    else 64 (both warpgroups on the same 64 rows, taking alternate tiles
    of the walk and adding their sums at the end), which doubles the CTAs.
    At train-dp2tp2's rank layer (2, 16 / 4 heads, 2048 rows) the dkv grid
    at 128 is 2 x 4 x 16 = 128 CTAs on 132 SMs: 64 rows. dkv at head_dim
    128 always takes 128: its dK and dV accumulators (128 fp32 registers a
    thread) leave no room for the 64-row form's alternation and merge."""
    if kernel == "dkv" and head_dim == 128:
        return 128
    return 128 if batch * heads * -(-blocks // 2) >= num_sms else 64


SM90_FWD_HEAD_DIMS = (64, 96, 128)   # csrc/flash_fwd_sm90.cu's head dims
SM90_FWD_MAX_WALK = 1024    # csrc/flash_fwd_sm90.cu MAX_WALK: 64-key tiles
SM90_FWD_MAX_SPLITS = 8     # csrc/flash_fwd_sm90.cu MAX_SPLITS: one cluster


def sm90_fwd_rows(batch: int, heads: int, blocks: int,
                  num_sms: int = H100_SMS) -> int:
    """The CTA tile of the sm90 forward (``csrc/flash_fwd_sm90.cu``) in
    rows, over ``blocks`` 64-row q blocks of ``batch * heads`` sequences:
    128 (one layout block per consumer warpgroup, both reading every K/V
    stage, so K/V cross into the SM once per 128 q rows) where that grid,
    ``batch * heads * ceil(blocks / 2)`` CTAs of one per SM, fills more
    than half the card; else 64 (both warpgroups on the same 64 rows,
    taking alternate kv tiles and merging at the end), which doubles the
    CTAs. Set by ``scripts/sm90_fwd_probe.py`` (PERF.md §6): 128
    rows took 0.68-0.86x the 64-row time at granite's train layer, bert's
    and qwen3's paged chunk (128 CTAs), 1.13-1.47x at three shapes of 64
    CTAs."""
    return 128 if 2 * batch * heads * -(-blocks // 2) > num_sms else 64


SM90_FWD_SPLIT_TILES = 32   # 64-key tiles each split of a walk keeps


def sm90_fwd_splits(batch: int, heads: int, blocks: int, kv_tiles: int,
                    num_sms: int = H100_SMS) -> int:
    """How many CTAs of one thread-block cluster deal the kv walk of one
    64-row q block of the sm90 forward, merging their partials through
    distributed shared memory: 1 while the 64-row CTAs (``batch * heads *
    blocks``) fill at least half the card; else as many as still fit the
    card once each (``num_sms // CTAs``), at most ``SM90_FWD_MAX_SPLITS``
    and at most ``kv_tiles / SM90_FWD_SPLIT_TILES``, so that each split
    walks 32 tiles (2048 keys) or more. ``scripts/sm90_fwd_probe.py`` set
    the walk floor (PERF.md §6): at seamless's cross prefill (64
    CTAs, 16 tiles) 2 splits took 0.97x the time of one and 4 or 8 took
    1.9-3.0x (the cluster launch, the merge), at serving chunks of 4-16
    tiles 1.4-8.2x; so no path's shape splits today."""
    ctas = batch * heads * blocks
    if 2 * ctas > num_sms:
        return 1
    return max(1, min(SM90_FWD_MAX_SPLITS, num_sms // ctas,
                      kv_tiles // SM90_FWD_SPLIT_TILES))


def check_decode_splits(num_splits: int) -> int:
    """The split counts the decode kernel (``flash_decode``,
    ``flash_decode_paged``) takes on the card: the splits of one sequence
    and kv head run as one thread-block cluster and merge there, and a
    portable cluster holds at most ``MAX_DECODE_SPLITS`` blocks. The
    resolvers never pick more on the card; an explicit larger count
    raises here, before any launch. The plain versions on the CPU take
    any count. Returns the split count."""
    if not 1 <= num_splits <= MAX_DECODE_SPLITS:
        raise ValueError(
            f"the decode kernels (flash_decode, flash_decode_paged) merge "
            f"their splits in one thread-block cluster and take 1 to "
            f"{MAX_DECODE_SPLITS} splits on the card, got {num_splits}")
    return num_splits


# ---------------------------------------------------------------------------
# Decode geometry
# ---------------------------------------------------------------------------

def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def decode_split_target(shards: int = 1,
                        target_splits: int = TARGET_DECODE_SPLITS, *,
                        on_card: bool = False) -> int:
    """Split-KV parallelism target of one shard's decode. Under tensor
    parallelism a shard's decode grid has ``heads / tp`` heads, so the
    reference scales the split count up by ``tp`` to keep the grid's
    occupancy. The CPU keeps that count; on the card it stays capped at
    ``MAX_DECODE_SPLITS``, the splits one thread-block cluster merges
    (``check_decode_splits``). Only the order of the float sums differs."""
    target = int(target_splits) * max(1, int(shards))
    return min(target, MAX_DECODE_SPLITS) if on_card else target


def choose_decode_geometry(capacity: int, *,
                           target_splits: int = TARGET_DECODE_SPLITS,
                           pinned_splits: int | None = None
                           ) -> tuple[int, int]:
    """``(block_k, num_splits)`` for a contiguous cache of ``capacity``
    slots. The split-KV kernel reads every valid cache byte once whatever
    the block, so the objective is parallelism, then the block: among
    row-aligned divisors of the capacity no larger than the kernel's ring
    tile (``DECODE_TILE``; the smallest aligned divisor when none is; the
    reference holds them to its VMEM budget instead, the card's shared
    memory is the fixed ring whatever the block), maximize the split count
    (capped at ``target_splits``), then the block. Divisor-valid by
    construction. ``pinned_splits`` (an explicit split count with an auto
    block) constrains the search; no block honouring it is an error, never
    a silent clamp."""
    cands = [b for b in _divisors_desc(capacity)
             if b % ROW_ALIGN == 0 or b == capacity]
    cands = [b for b in cands if b <= DECODE_TILE] or [min(cands)]
    best = None
    for blk in cands:
        nk = capacity // blk
        if pinned_splits is not None:
            if nk % pinned_splits:
                continue
            key = (pinned_splits, blk)
        else:
            key = (next(s for s in _divisors_desc(nk) if s <= target_splits),
                   blk)
        if best is None or key > best:
            best = key
    if best is None:
        raise ValueError(
            f"flash_decode: no aligned kv block of the {capacity}-slot cache "
            f"yields a grid divisible by num_splits ({pinned_splits}); pick "
            f"a num_splits dividing the block count or leave it auto")
    return best[1], best[0]


def resolve_paged_decode_splits(pages_per_seq: int,
                                num_splits: int | None = None, *,
                                target_splits: int = TARGET_DECODE_SPLITS
                                ) -> int:
    """Split count for paged decode: auto picks the largest divisor of the
    pages per sequence not above the target; an explicit value is
    validated (clamped to the page count, must divide it)."""
    from repro_torch.kernels.flash_decode import validate_paged_decode_geometry
    pages_per_seq = max(1, pages_per_seq)
    if num_splits is None:
        return next(s for s in _divisors_desc(pages_per_seq)
                    if s <= target_splits)
    return validate_paged_decode_geometry(pages_per_seq, int(num_splits))


# ---------------------------------------------------------------------------
# Analytic chooser (Alg. 1 line 1 with the kernels' true footprint)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def _analytic_choice(sq: int, sk: int, head_dim: int, elt: int,
                     backward: bool, budget: int,
                     fixed_bq: int | None, fixed_bk: int | None,
                     decode_capacity: int | None,
                     heads_q: int = 1, heads_kv: int = 1,
                     shards: int = 1, paged: bool = False) -> TileConfig:
    bq_cands = [fixed_bq] if fixed_bq is not None else _aligned_candidates(sq)
    bk_cands = [fixed_bk] if fixed_bk is not None else _aligned_candidates(sk)
    best: tuple | None = None
    for bq in bq_cands:
        for bk in bk_cands:
            ws = attention_working_set_bytes(bq, bk, head_dim, bf16=elt == 2,
                                             paged=paged, backward=backward)
            fits = ws <= budget
            hbm = io_model.flash_hbm_bytes_tiled(
                sq, sk, head_dim, 1, 1, bq, bk, elt=elt,
                fwd_and_bwd=backward)
            # a sharded call sees only heads/tp local heads, so its (head,
            # q-block) grid can collapse to a few CTAs: keep
            # TARGET_GRID_CELLS busy before minimizing HBM bytes.
            par_ok = (shards <= 1
                      or max(1, heads_q) * -(-sq // bq) >= TARGET_GRID_CELLS)
            # fitting first; among fitting, fewest HBM bytes, then the
            # larger tile; among non-fitting (a pinned over-budget tile, or
            # a budget below one minimal tile) the smallest footprint.
            key = (fits, par_ok, -hbm if fits else -ws, bq + bk, bk)
            if best is None or key > best[:5]:
                best = key + (bq, bk)
    dec_blk = dec_splits = None
    if decode_capacity is not None:
        dec_blk, dec_splits = choose_decode_geometry(decode_capacity)
    return TileConfig(block_q=best[5], block_k=best[6],
                      decode_block_k=dec_blk, num_decode_splits=dec_splits,
                      source="analytic")


def choose_tile_config(sq: int, sk: int, head_dim: int, *,
                       dtype: Any = "float32", backward: bool = True,
                       sram_budget_bytes: int | None = None,
                       decode_capacity: int | None = None,
                       block_q: int | None = None,
                       block_k: int | None = None,
                       heads_q: int = 1, heads_kv: int = 1,
                       shards: int = 1, paged: bool = False) -> TileConfig:
    """Analytic tile choice (see the module docstring). Explicit
    ``block_q`` / ``block_k`` pin that axis and the chooser fills the
    rest. ``shards`` > 1 means the call runs inside a ``tp``-sharded step
    with PER-SHARD head counts in ``heads_q`` / ``heads_kv``: the chooser
    then keeps per-device grid occupancy above ``TARGET_GRID_CELLS``
    (block_q shrinks with the local head count). ``paged`` fits the paged
    bodies' shared memory. The loop order is always q-major
    (``kv_major=False``)."""
    budget = (sram_budget() if sram_budget_bytes is None
              else int(sram_budget_bytes))
    return _analytic_choice(int(sq), int(sk), int(head_dim),
                            elt_bytes(dtype), bool(backward), budget,
                            block_q, block_k, decode_capacity,
                            int(heads_q), int(heads_kv), int(shards),
                            bool(paged))


# ---------------------------------------------------------------------------
# Empirical autotuner + persistent cache
# ---------------------------------------------------------------------------

def seq_bucket(n: int) -> int:
    """Pow-2 bucket so one timing run covers a band of nearby lengths."""
    b = LANES
    while b < n:
        b *= 2
    return b


def cache_key(device_kind: str, dtype: Any, head_dim: int, bucket: int,
              mask_class: str, shards: int = 1, sp: int = 1) -> str:
    """Autotune cache key, the reference's. ``shards`` > 1 namespaces
    tensor-parallel resolutions (``|tpN``): the per-shard head count
    changes which tiles win. ``sp`` > 1 namespaces sequence-parallel
    prefill resolutions (``|spN``): the per-shard q slab is ``1/sp`` of
    the chunk."""
    key = f"{device_kind}|{_dtype_name(dtype)}|{head_dim}|" \
          f"{bucket}|{mask_class}"
    if shards > 1:
        key += f"|tp{int(shards)}"
    if sp > 1:
        key += f"|sp{int(sp)}"
    return key


# Nominal HBM bandwidth per device kind, the denominator of the calibration
# factor (the IO model's bytes over the clock, against what the hardware
# claims). Unknown kinds (the CPU included) fall back to the reference's
# generic DDR-class figure.
_NOMINAL_HBM_BW: dict[str, float] = {"H100": io_model.H100_HBM_BW}
_FALLBACK_HBM_BW = 5e10


def nominal_hbm_bw(device_kind: str) -> float:
    for k, bw in _NOMINAL_HBM_BW.items():
        if k.lower() in device_kind.lower():
            return bw
    return _FALLBACK_HBM_BW


class AutotuneCache:
    """JSON-file persistence for autotuned ``TileConfig``s, the reference's
    file: ``{"version": 1, "entries", "calibration"}``. Load is lazy. A
    ``put`` may race another process's (every rank of a sharded launch
    tunes into one file), so it holds an exclusive ``flock`` on
    ``<path>.lock``, re-reads the file, adds its entry and its calibration
    sample to what is on disk, and writes a temporary file that
    ``os.replace`` puts in place: no entry another process added is lost,
    and a reader never sees a half-written file. An entry may also carry
    ``candidates_us`` and ``spread_us``, every timed candidate's least
    time and the spread of its samples (the reference's reader ignores
    them).

    ``calibration`` aggregates, per device kind, every timed winner's
    ``(model_hbm_bytes, timed_us)``: the IO model's implied bandwidth and
    its ratio to the kind's nominal one."""

    def __init__(self, path: str):
        self.path = path
        self._entries: dict[str, dict] | None = None
        self._calib: dict[str, dict] | None = None
        self.hits = 0
        self.misses = 0

    def _read(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            self._entries = doc.get("entries", {})
            self._calib = doc.get("calibration", {})
        except (OSError, ValueError):
            self._entries = {}
            self._calib = {}

    def _load(self) -> dict[str, dict]:
        if self._entries is None:
            self._read()
        return self._entries

    def get(self, key: str) -> TileConfig | None:
        entry = self._load().get(key)
        if entry is None:
            self.misses += 1
            default_registry().counter("tuning_cache_misses").inc()
            return None
        self.hits += 1
        default_registry().counter("tuning_cache_hits").inc()
        return TileConfig.from_cache_entry(entry)

    def put(self, key: str, cfg: TileConfig, timed_us: float, *,
            model_hbm_bytes: float | None = None,
            device_kind: str | None = None,
            candidates_us: dict[str, float] | None = None,
            spread_us: dict[str, float] | None = None) -> None:
        default_registry().histogram(
            "autotune_timed_us",
            buckets=(10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0, 10000.0,
                     50000.0)).observe(float(timed_us))
        entry = {**cfg.as_cache_entry(), "timed_us": timed_us}
        if candidates_us is not None:
            entry["candidates_us"] = dict(candidates_us)
        if spread_us is not None:
            entry["spread_us"] = dict(spread_us)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            self._read()
            if model_hbm_bytes is not None:
                entry["model_hbm_bytes"] = float(model_hbm_bytes)
                if timed_us > 0 and device_kind:
                    c = self._calib.setdefault(
                        device_kind, {"samples": 0, "model_bytes": 0.0,
                                      "us": 0.0})
                    c["samples"] += 1
                    c["model_bytes"] += float(model_hbm_bytes)
                    c["us"] += float(timed_us)
            self._entries[key] = entry
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": 1, "entries": self._entries,
                           "calibration": self._calib}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)

    def calibration(self, device_kind: str) -> dict | None:
        """Aggregate calibration for one device kind, or None before any
        timed sample. ``vs_nominal`` is the model-implied bandwidth over
        the kind's nominal one (1.0 = the IO model's bytes at nominal speed
        explain the clock exactly)."""
        self._load()
        c = (self._calib or {}).get(device_kind)
        if not c or c["us"] <= 0:
            return None
        bytes_per_s = c["model_bytes"] / (c["us"] * 1e-6)
        return {"samples": c["samples"],
                "model_bytes_per_s": bytes_per_s,
                "vs_nominal": bytes_per_s / nominal_hbm_bw(device_kind)}


_CACHE: AutotuneCache | None = None


def autotune_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None or _CACHE.path != _STATE["cache_path"]:
        _CACHE = AutotuneCache(_STATE["cache_path"])
    return _CACHE


def _device_kind(device: Any = "cuda") -> str:
    """The cache's device kind: the card's name (``|`` made ``_``), or
    ``"cpu"``."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace("|", "_")


def _clock_us(fn, device, iters: int, reps: int = TIMED_REPS
              ) -> tuple[float, float]:
    """``fn``'s time per call: the least and the spread (most less least)
    of ``iters`` samples, after one warm-up call outside the timing.
    Microseconds. On the CPU a sample is one call under
    ``time.perf_counter``. On the card a sample is ``reps`` back-to-back
    calls between one pair of CUDA events, queued behind a
    ``torch.cuda._sleep`` that outlasts their host work, so the events
    read the device's time and not the wrappers' (a small kernel takes
    far less than its wrapper's host work)."""
    import torch
    fn()
    if torch.device(device).type != "cuda":
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e6, (max(ts) - min(ts)) * 1e6
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    # cycles at 2 GHz (above the H100's top clock, so the sleep is never
    # shorter than meant), twice the host time of the queued calls,
    # 0.2 s at most
    cycles = int(min(2.0 * reps * host_s, 0.2) * 2e9)
    ts = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / reps)
    return min(ts) * 1e3, (max(ts) - min(ts)) * 1e3


def _winner(times: dict, default) -> tuple[Any, float]:
    """The timed winner and its time, ``times`` holding (least, spread)
    per candidate. A candidate beats ``default`` (the analytic choice)
    only by more than the spread of either one's samples: a win inside
    the clock's own noise would be persisted, and never timed again."""
    best = min(times, key=lambda c: times[c][0])
    if default in times and best != default:
        (t_b, s_b), (t_d, s_d) = times[best], times[default]
        if t_d - t_b <= max(s_b, s_d):
            best = default
    return best, times[best][0]


def _randn(shape, dtype, device, gen):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, _dtype_name(dtype)))


def _time_candidates(sq: int, sk: int, head_dim: int, dtype,
                     candidates: list[tuple[int, int]], *,
                     causal: bool, heads_q: int = 2, heads_kv: int = 2,
                     backward: bool = False, iters: int = 3,
                     device: Any = "cuda") -> dict[tuple[int, int], float]:
    """Time, per ``(block_q, block_k)`` candidate on ``device``, the
    kernels ``ops.flash_attention`` launches at (1, heads, sq/sk,
    head_dim): the forward, and with ``backward`` the forward and the
    backward pair, so the winner is the tile that wins the training step.
    The inputs are padded to the tiles and the layout compiled once per
    candidate, outside the clock: the wrapper's host work (and the host
    copy that syncs it with the card) does not depend on the tile and
    would only hide the kernels' time. Returns (least, spread)
    microseconds by candidate (``_clock_us``)."""
    import torch

    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn((1, heads_q, sq, head_dim), dtype, device, gen)
    k = _randn((1, heads_kv, sk, head_dim), dtype, device, gen)
    v = _randn((1, heads_kv, sk, head_dim), dtype, device, gen)
    do = _randn((1, heads_q, sq, head_dim), dtype, device, gen)
    times = {}
    for bq, bk in candidates:
        sq_p, sk_p = -(-sq // bq) * bq, -(-sk // bk) * bk
        qp, dop = (torch.nn.functional.pad(t, (0, 0, 0, sq_p - sq))
                   for t in (q, do))
        kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, sk_p - sk))
                  for t in (k, v))
        spec = M.MaskSpec(causal=causal, q_offset=sk - sq,
                          kv_valid_len=sk if sk_p != sk else None)
        layout = M.compile_block_layout(spec, sq_p, sk_p, bq,
                                        bk).as_array(device)
        call = dict(scale=head_dim ** -0.5, causal=causal, window=None,
                    q_offset=spec.q_offset, kv_valid_len=spec.kv_valid_len,
                    block_q=bq, block_k=bk)

        def run(qp=qp, kp=kp, vp=vp, dop=dop, layout=layout, call=call):
            o, m, l = fa.flash_attention_forward(qp, kp, vp, None, layout,
                                                 **call)
            if backward:
                fa.flash_attention_backward(qp, kp, vp, o, dop, m, l, None,
                                            layout, **call)
        times[(bq, bk)] = _clock_us(run, device, iters)
    return times


def _timed_list(analytic: TileConfig, head_dim: int, elt: int,
                backward: bool, block_q: int | None, block_k: int | None,
                max_candidates: int) -> list[tuple[int, int]]:
    """The autotuner's timed candidates: the analytic choice, then the
    fitting pairs of ``TIMED_TILES`` (a pinned axis keeps its pin) by
    descending area, cut to ``max_candidates``. The reference times every
    lane-aligned pair after its analytic choice; a tile that is not a
    multiple of 16 runs padded to one in the mma bodies, so timing 56
    next to 64 tells nothing."""
    cands = [(analytic.block_q, analytic.block_k)]
    pairs = [(bq, bk)
             for bq in ([block_q] if block_q is not None else TIMED_TILES)
             for bk in ([block_k] if block_k is not None else TIMED_TILES)]
    for bq, bk in sorted(pairs, key=lambda t: (-t[0] * t[1], -t[0])):
        ws = attention_working_set_bytes(bq, bk, head_dim, bf16=elt == 2,
                                         backward=backward)
        if ws <= sram_budget() and (bq, bk) not in cands:
            cands.append((bq, bk))
    return cands[:max_candidates]


def autotune_tiles(sq: int, sk: int, head_dim: int, *, dtype,
                   mask_class: str, backward: bool = True,
                   max_candidates: int = 4,
                   block_q: int | None = None,
                   block_k: int | None = None,
                   heads_q: int = 1, heads_kv: int = 1,
                   shards: int = 1, sp: int = 1,
                   device: Any = "cuda") -> TileConfig:
    """Empirical resolution: cache lookup, else time the candidates
    (``_timed_list``) at the sequence's pow-2 bucket on ``device`` and
    persist the winner (``_winner``: the analytic choice unless beaten by
    more than the clock's spread) with every candidate's time. A pinned
    ``block_q`` /
    ``block_k`` axis constrains the candidates and joins the key
    (``|bq=`` / ``|bk=``), so a pinned call never reuses or pollutes the
    unpinned entry; so does the head-group ratio (``|g=``).
    ``backward=True`` (a trainable call) times the forward + backward
    under its own ``|bwd`` key, so inference and training resolutions
    never serve each other's winner."""
    bucket = seq_bucket(max(sq, sk))
    kind = _device_kind(device)
    key = cache_key(kind, dtype, head_dim, bucket, mask_class,
                    shards=shards, sp=sp)
    if block_q is not None:
        key += f"|bq={block_q}"
    if block_k is not None:
        key += f"|bk={block_k}"
    n_rep = max(1, heads_q // max(heads_kv, 1))
    if n_rep > 1:
        key += f"|g={n_rep}"
    if backward:
        key += "|bwd"
    cache = autotune_cache()
    hit = cache.get(key)
    if hit is not None:
        return hit
    analytic = choose_tile_config(bucket, bucket, head_dim, dtype=dtype,
                                  backward=backward,
                                  block_q=block_q, block_k=block_k,
                                  heads_q=heads_q, heads_kv=heads_kv,
                                  shards=shards)
    elt = elt_bytes(dtype)
    times = _time_candidates(
        bucket, bucket, head_dim, dtype,
        _timed_list(analytic, head_dim, elt, backward, block_q, block_k,
                    max_candidates),
        causal="causal" in mask_class, heads_q=max(heads_q, 1),
        heads_kv=max(heads_kv, 1), backward=backward, device=device)
    (bq, bk), t_us = _winner(times, (analytic.block_q, analytic.block_k))
    cfg = dataclasses.replace(analytic, block_q=bq, block_k=bk,
                              source="autotuned")
    # calibration sample: the winner's IO-model bytes for the TIMED shape
    # (batch 1, heads_q heads) against its clock
    model_bytes = io_model.flash_hbm_bytes_tiled(
        bucket, bucket, head_dim, max(heads_q, 1), 1, bq, bk, elt=elt,
        fwd_and_bwd=backward)
    cache.put(key, cfg, t_us, model_hbm_bytes=model_bytes, device_kind=kind,
              candidates_us={f"{a}x{b}": t for (a, b), (t, _) in
                             times.items()},
              spread_us={f"{a}x{b}": sp for (a, b), (_, sp) in
                         times.items()})
    return cfg


def _time_decode_candidates(capacity: int, head_dim: int, dtype,
                            candidates: list[tuple[int, int]], *,
                            page_size: int | None = None, iters: int = 3,
                            device: Any = "cuda"
                            ) -> dict[tuple[int, int], float]:
    """Time the whole decode per ``(block_k, num_splits)`` candidate —
    contiguous (``flash_decode``'s launch) or paged
    (``flash_decode_paged``'s) — for one sequence of 2 q / 2 kv heads at
    full capacity, its layout lowered once per candidate outside the
    clock (as ``_time_candidates``). (least, spread) microseconds by
    candidate (``_clock_us``)."""
    import torch

    from repro_torch.core import masks as M
    from repro_torch.kernels import flash_decode as fd

    hq = hkv = 2
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn((1, hq, 1, head_dim), dtype, device, gen)
    kv_len = torch.tensor([capacity], dtype=torch.int32, device=device)
    scale = head_dim ** -0.5
    if page_size is None:
        kc = _randn((1, hkv, capacity, head_dim), dtype, device, gen)
        vc = _randn((1, hkv, capacity, head_dim), dtype, device, gen)
        valid = M.decode_kv_valid(kv_len, capacity)

        def make(blk, splits):
            lay = M.kv_block_layout(valid, blk)
            return lambda: fd.flash_decode_from_layout(
                q, kc, vc, kv_len, lay, scale=scale, block_k=blk,
                num_splits=splits, window=None)
    else:
        pages = max(1, capacity // page_size)
        kp = _randn((hkv, pages, page_size, head_dim), dtype, device, gen)
        vp = _randn((hkv, pages, page_size, head_dim), dtype, device, gen)
        table = torch.arange(pages, dtype=torch.int32, device=device)[None]
        lay = M.paged_block_layout(kv_len, table, page_size)

        def make(blk, splits):
            return lambda: fd.flash_decode_paged_from_layout(
                q, kp, vp, table, kv_len, lay, scale=scale,
                num_splits=splits, window=None)

    return {c: _clock_us(make(*c), device, iters) for c in candidates}


def decode_candidates(capacity: int, *, page_size: int | None = None,
                      target_splits: int = TARGET_DECODE_SPLITS
                      ) -> list[tuple[int, int]]:
    """The decode autotuner's ``(block_k, num_splits)`` candidates, in the
    reference's order, at most ``MAX_DECODE_SPLITS`` splits (what the card
    takes): paged, the page with each divisor of the pages per sequence
    up to twice the target; contiguous, the analytic choice, then each
    aligned divisor of the capacity with its split count."""
    cap = min(2 * target_splits, MAX_DECODE_SPLITS)
    if page_size is not None:
        pages = max(1, capacity // page_size)
        return [(page_size, s) for s in _divisors_desc(pages) if s <= cap]
    target = min(target_splits, MAX_DECODE_SPLITS)
    cands = [choose_decode_geometry(capacity, target_splits=target)]
    for b2 in _divisors_desc(capacity):
        if b2 % ROW_ALIGN or b2 == capacity:
            continue
        nk = capacity // b2
        s2 = next(s for s in _divisors_desc(nk) if s <= target)
        if (b2, s2) not in cands:
            cands.append((b2, s2))
    return cands


def autotune_decode_geometry(capacity: int, head_dim: int, *, dtype,
                             page_size: int | None = None,
                             target_splits: int = TARGET_DECODE_SPLITS,
                             max_candidates: int = 4,
                             shards: int = 1,
                             device: Any = "cuda") -> TileConfig:
    """Empirical decode resolution: time ``decode_candidates`` and persist
    the winner (``_winner``: the analytic geometry unless beaten by more
    than the clock's spread). Keyed by EXACT capacity (not the bucket): split validity
    is a divisibility property of the real grid. For a paged cache the
    block is the page and only the split count is searched."""
    kind = f"paged{page_size}" if page_size is not None else "contig"
    dev_kind = _device_kind(device)
    key = (f"decode|{dev_kind}|{_dtype_name(dtype)}|{head_dim}|"
           f"{capacity}|{kind}")
    if shards > 1:
        key += f"|tp{int(shards)}"
        target_splits = decode_split_target(shards, target_splits)
    cache = autotune_cache()
    hit = cache.get(key)
    if hit is not None and hit.decode_block_k is not None:
        return hit
    cands = decode_candidates(capacity, page_size=page_size,
                              target_splits=target_splits)[:max_candidates]
    times = _time_decode_candidates(capacity, head_dim, dtype, cands,
                                    page_size=page_size, device=device)
    default = (cands[0] if page_size is None else
               (page_size, resolve_paged_decode_splits(
                   capacity // page_size,
                   target_splits=min(target_splits, MAX_DECODE_SPLITS))))
    (blk, splits), t_us = _winner(times, default)
    cfg = TileConfig(block_q=1, block_k=blk, decode_block_k=blk,
                     num_decode_splits=splits, source="autotuned")
    # calibration: decode reads every valid K/V byte once, 2 kv heads at
    # full capacity (q/o traffic ~0)
    model_bytes = float(2 * 2 * capacity * head_dim * elt_bytes(dtype))
    cache.put(key, cfg, t_us, model_hbm_bytes=model_bytes,
              device_kind=dev_kind,
              candidates_us={f"{b}x{s}": t for (b, s), (t, _) in
                             times.items()},
              spread_us={f"{b}x{s}": sp for (b, s), (_, sp) in
                         times.items()})
    return cfg


# ---------------------------------------------------------------------------
# Resolution entry points (what the ops, the engine and the models call)
# ---------------------------------------------------------------------------

def mask_class_of(*, causal: bool = False, window: int | None = None,
                  has_kv_mask: bool = False, has_segments: bool = False,
                  has_sparse: bool = False,
                  has_positions: bool = False) -> str:
    parts = [p for p, on in [("causal", causal), ("win", window is not None),
                             ("seg", has_segments), ("kvm", has_kv_mask),
                             ("sparse", has_sparse),
                             ("pos", has_positions)] if on]
    return "+".join(parts) or "dense"


def resolve_tiles(block_q: int | None, block_k: int | None, *,
                  sq: int, sk: int, head_dim: int, dtype: Any,
                  mask_class: str = "dense",
                  backward: bool = True,
                  heads_q: int = 1, heads_kv: int = 1,
                  shards: int = 1, paged: bool = False,
                  device: Any = "cuda") -> TileConfig:
    """THE audited decision point for training/prefill tiles.

    Explicit (non-``None``) values pass through; ``None`` means auto —
    empirical on ``device`` when autotuning is enabled, analytic
    otherwise. The caller still owes ``round_block`` against its true
    (possibly ragged) sequence lengths. ``shards`` is the tensor-parallel
    shard count of the calling step (1 = unsharded): it joins the
    autotune key and biases the chooser toward per-device grid occupancy,
    since ``heads_q`` / ``heads_kv`` are then per-shard counts."""
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None and int(blk) < 1:
            raise ValueError(f"{name}: a tile of {blk} rows: pass a "
                             f"positive block or None (auto)")
    if block_q is not None and block_k is not None:
        return TileConfig(block_q=int(block_q), block_k=int(block_k),
                          source="explicit")
    if autotune_enabled():
        return autotune_tiles(sq, sk, head_dim, dtype=dtype,
                              mask_class=mask_class, backward=backward,
                              block_q=block_q, block_k=block_k,
                              heads_q=heads_q, heads_kv=heads_kv,
                              shards=shards, device=device)
    return choose_tile_config(sq, sk, head_dim, dtype=dtype,
                              backward=backward,
                              block_q=block_q, block_k=block_k,
                              heads_q=heads_q, heads_kv=heads_kv,
                              shards=shards, paged=paged)


def resolve_sp_strategy(chunk: int, prefix: int, head_dim: int, *,
                        heads_q: int = 1, heads_kv: int = 1, sp: int = 1,
                        dtype: Any = "float32", layers: int = 1,
                        device: Any = "cuda") -> dict:
    """The sequence-parallel prefill's K/V movement and per-shard (slab)
    tiles for one engine shape (DESIGN.md §14): both strategies costed
    against replicated prefill by ``io_model.sp_prefill_hbm_bytes`` at
    the slab's analytically chosen ``block_q`` (``heads_q`` / ``heads_kv``
    per tensor-parallel shard). With autotuning enabled the decision
    persists under the ``|spN`` key (the entry carries the slab tiles and
    ``sp_strategy``), so a repeat engine resolves from the cache.

    Returns ``{"strategy", "costs", "tiles", "source"}``; at sp <= 1 the
    strategy is "allgather" (never used) and nothing persists."""
    slab = max(1, -(-int(chunk) // max(1, int(sp))))
    tiles = choose_tile_config(slab, prefix + chunk, head_dim, dtype=dtype,
                               backward=False, heads_q=heads_q,
                               heads_kv=heads_kv, shards=max(1, sp))
    costs = io_model.sp_prefill_hbm_bytes(
        chunk, prefix, head_dim, max(1, heads_q), max(1, heads_kv), sp,
        block_q=tiles.block_q, elt=elt_bytes(dtype), layers=max(1, layers))
    if sp <= 1:
        return {"strategy": "allgather", "costs": costs, "tiles": tiles,
                "source": "analytic"}
    strategy = costs["best"]
    if autotune_enabled():
        key = cache_key(_device_kind(device), dtype, head_dim,
                        seq_bucket(chunk), "causal+seg+pos", sp=sp)
        cache = autotune_cache()
        hit = cache.get(key)
        if hit is not None and hit.sp_strategy in ("allgather", "ring"):
            return {"strategy": hit.sp_strategy, "costs": costs,
                    "tiles": hit, "source": "cache"}
        cfg = dataclasses.replace(tiles, sp_strategy=strategy)
        # an analytic decision, not a timed one: no calibration sample
        cache.put(key, cfg, 0.0)
        return {"strategy": strategy, "costs": costs, "tiles": cfg,
                "source": "analytic"}
    return {"strategy": strategy, "costs": costs, "tiles": tiles,
            "source": "analytic"}


def resolve_decode_geometry(capacity: int, block_k: int | None,
                            num_splits: int | None, *,
                            head_dim: int | None = None,
                            dtype: Any = "float32",
                            page_size: int | None = None,
                            target_splits: int = TARGET_DECODE_SPLITS,
                            shards: int = 1, on_card: bool = False,
                            device: Any = "cuda") -> tuple[int, int]:
    """Decode ``(block_k, num_splits)`` for a contiguous or paged cache.
    For a paged cache the kv block IS the page: an explicit conflicting
    ``block_k`` is rejected, and ``capacity`` is the per-sequence capacity
    (``pages_per_seq * page_size``). With both left None and autotuning
    enabled, the timed winner (``autotune_decode_geometry`` on
    ``device``; needs ``head_dim``). ``shards`` scales the auto split
    target (``decode_split_target``), capped at ``MAX_DECODE_SPLITS``
    ``on_card``. Explicit values are validated as in the JAX package
    (clamped to the cache, misalignment raises); auto values are valid by
    construction."""
    from repro_torch.kernels.flash_decode import validate_decode_geometry

    if block_k is None and num_splits is None and autotune_enabled():
        # the timed candidates pass explicit geometry: no re-entry here
        cfg = autotune_decode_geometry(capacity, head_dim, dtype=dtype,
                                       page_size=page_size,
                                       target_splits=target_splits,
                                       shards=shards, device=device)
        block_k, num_splits = cfg.decode_block_k, cfg.num_decode_splits
    target_splits = decode_split_target(shards, target_splits,
                                        on_card=on_card)
    if page_size is not None:
        if block_k is not None and int(block_k) != int(page_size):
            raise ValueError(
                f"paged decode: block_k ({block_k}) must equal page_size "
                f"({page_size}) — the page is the unit of cache allocation "
                f"and the mask IR's kv block; re-tile the pool or leave "
                f"block_k auto")
        return int(page_size), resolve_paged_decode_splits(
            capacity // page_size, num_splits, target_splits=target_splits)
    if block_k is None:
        block_k, num_splits = choose_decode_geometry(
            capacity, target_splits=target_splits,
            pinned_splits=None if num_splits is None else int(num_splits))
    elif num_splits is None:
        block_k = min(int(block_k), capacity)
        nk = max(1, capacity // max(int(block_k), 1))
        num_splits = next(s for s in _divisors_desc(nk) if s <= target_splits)
    return validate_decode_geometry(capacity, int(block_k), int(num_splits))


# ---------------------------------------------------------------------------
# CLI: the autotune round trip
# ---------------------------------------------------------------------------

def _main(argv=None) -> None:
    import argparse

    from repro_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shape (256, d=64) so the round trip is cheap")
    ap.add_argument("--cache", default=None, help="autotune cache path")
    ap.add_argument("--sram-budget", type=int, default=None)
    ap.add_argument("--expect-hit", action="store_true",
                    help="fail unless resolution was served from the cache")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shard count: resolve against the "
                         "per-shard cache-key namespace (|tpN)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel shard count: resolve the sp "
                         "prefill strategy + slab tiles under |spN")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    configure_tuning(sram_budget=args.sram_budget, autotune=True,
                     cache_path=args.cache)
    seq = args.seq if args.seq is not None else (256 if args.smoke else 2048)
    d = args.head_dim
    cfg = autotune_tiles(seq, seq, d, dtype="float32", mask_class="causal",
                         backward=False, shards=args.tp, device=dev)
    cache = autotune_cache()
    fixed = io_model.flash_hbm_bytes_tiled(seq, seq, d, 1, 1, MAX_TILE,
                                           MAX_TILE, elt=4)
    chosen = io_model.flash_hbm_bytes_tiled(seq, seq, d, 1, 1, cfg.block_q,
                                            cfg.block_k, elt=4)
    hit = cfg.source == "cache"
    print(f"autotune seq={seq} d={d}: block_q={cfg.block_q} "
          f"block_k={cfg.block_k} source={cfg.source} "
          f"hbm_vs_64x64={chosen / fixed:.3f} cache_hit={hit} "
          f"(hits={cache.hits} misses={cache.misses}) path={cache.path}")
    bwd = autotune_tiles(seq, seq, d, dtype="float32", mask_class="causal",
                         backward=True, shards=args.tp, device=dev)
    bwd_hit = bwd.source == "cache"
    print(f"autotune bwd seq={seq} d={d}: block_q={bwd.block_q} "
          f"block_k={bwd.block_k} source={bwd.source} cache_hit={bwd_hit}")
    dec = autotune_decode_geometry(seq, d, dtype="float32", shards=args.tp,
                                   device=dev)
    dec_hit = dec.source == "cache"
    print(f"autotune decode cap={seq} d={d}: block_k={dec.decode_block_k} "
          f"splits={dec.num_decode_splits} source={dec.source} "
          f"cache_hit={dec_hit}")
    sp_hit = True
    if args.sp > 1:
        res = resolve_sp_strategy(seq, 4 * seq, d, heads_q=2, heads_kv=2,
                                  sp=args.sp, dtype="float32", device=dev)
        sp_hit = res["source"] == "cache"
        c = res["costs"]
        print(f"autotune sp={args.sp} chunk={seq}: "
              f"strategy={res['strategy']} source={res['source']} "
              f"cache_hit={sp_hit} speedup_vs_replicated="
              f"{c['replicated'] / min(c['allgather'], c['ring']):.2f}")
    kind = _device_kind(dev)
    cal = cache.calibration(kind)
    if cal is not None:
        print(f"calibration[{kind}]: io_model-implied "
              f"{cal['model_bytes_per_s'] / 1e9:.2f} GB/s over "
              f"{cal['samples']} timed samples = {cal['vs_nominal']:.3f}x "
              f"nominal ({nominal_hbm_bw(kind) / 1e9:.0f} GB/s)")
    if args.expect_hit and not (hit and bwd_hit and dec_hit and sp_hit):
        raise SystemExit("expected a cache hit but resolution re-tuned "
                         f"(fwd={hit} bwd={bwd_hit} decode={dec_hit} "
                         f"sp={sp_hit})")


if __name__ == "__main__":
    _main()
