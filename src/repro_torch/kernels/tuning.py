"""Hopper tile choice for the hand-written attention kernels.

The JAX package's tuner (analytic SRAM-budget chooser + empirical
autotuner, ``repro.kernels.tuning``) is not ported yet. This module holds
the small part the serving path needs:

  * ``round_block`` — clamp a block to a sequence without emitting an
    unaligned tile (rows in multiples of ``ROW_ALIGN``; the caller pads);
  * ``sparse_tile`` — the kernel tile under a block-sparse pattern's
    block (the pattern refined to ``MAX_TILE`` where its block is a
    multiple of it; any other block above it raises on the card);
  * ``fwd_tiles`` / ``bwd_tiles`` — one fixed (block_q, block_k) per
    head_dim whose shared-memory footprint in ``csrc/flash_fwd.cu`` /
    ``csrc/flash_bwd.cu`` (``fwd_smem_bytes`` / ``bwd_smem_bytes``, fp32
    and bf16 bodies, from ``core.io_model``) fits a Hopper block;
  * ``fwd_pages_per_tile`` — the pages one kv tile of the paged forward
    gathers (raises for a page size the kernel does not take),
    ``check_page_size`` — the page sizes every paged kernel takes (a paged
    engine on the card checks its page at construction), and
    ``fwd_kv_groups`` (from ``core.io_model``) — the warp groups that
    split one CTA's kv walk (the bf16 forward's and the bf16 dq's alike);
  * ``resolve_paged_decode_splits`` — split-KV parallelism for paged decode
    with the divisor rule of ``flash_decode.validate_paged_decode_geometry``,
    ``decode_split_target`` — its target, scaled by the tensor-parallel
    shard count as in the reference and capped on the card — and
    ``check_decode_splits`` — the split counts the decode kernel takes
    on the card (its splits merge in one thread-block cluster);
  * ``resolve_sp_strategy`` — the sequence-parallel prefill's K/V movement
    ("allgather" or "ring"), costed by ``io_model.sp_prefill_hbm_bytes``
    at the forward kernel's own q tile;
  * ``choose_decode_geometry`` / ``resolve_decode_geometry`` — the
    contiguous cache's ``(block_k, num_splits)``: a Hopper chooser in place
    of the JAX package's SRAM-budget one, explicit values validated by
    ``flash_decode.validate_decode_geometry`` (misalignment raises, the
    cache is never padded).
"""

from __future__ import annotations

from repro_torch.core import io_model
from repro_torch.core.io_model import H100_SMEM_PER_BLOCK as SMEM_PER_BLOCK
from repro_torch.core.io_model import MAX_TILE  # csrc/flash_fwd.cu MAX_BQ / MAX_BK
from repro_torch.core.io_model import (attention_working_set_bytes,
                                       bwd_smem_bytes, fwd_kv_groups,
                                       fwd_smem_bytes)

ROW_ALIGN = 8               # tile rows: multiple of 8 (one mma.sync m-tile)
PAGE_SIZES = (8, 16, 32, 64)    # pages the paged kernels take on the card
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
TARGET_DECODE_SPLITS = 8    # split-KV parallelism target
MAX_DECODE_SPLITS = 8       # csrc/flash_decode.cu MAX_SPLITS: portable cluster size
DECODE_TILE = 64            # csrc/flash_decode.cu TILE: kv rows of one ring stage


def round_block(requested: int, seq_len: int) -> int:
    """Clamp a block size to a sequence WITHOUT producing an unaligned
    tile: cap at the sequence rounded UP to ``ROW_ALIGN`` (the caller pads
    the operand to a block multiple) and round down to ``ROW_ALIGN``,
    floor ``ROW_ALIGN``."""
    cap = -(-max(seq_len, 1) // ROW_ALIGN) * ROW_ALIGN
    blk = min(int(requested), cap)
    blk = max(ROW_ALIGN, (blk // ROW_ALIGN) * ROW_ALIGN)
    return min(blk, cap)


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
    """The fixed (block_q, block_k) for a head_dim: 64 x 64 fits shared
    memory for every head_dim the kernel takes (115 KB fp32, 84 KB bf16,
    152 KB bf16 paged at d = 128; 90 KB, 63 KB and 115 KB at d = 96)."""
    bq = bk = MAX_TILE
    for bf16, paged in ((False, False), (True, False), (True, True)):
        assert attention_working_set_bytes(
            bq, bk, max(KERNEL_HEAD_DIMS), bf16=bf16, paged=paged,
            backward=False) <= SMEM_PER_BLOCK
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
    into one kv tile, so a page is 8, 16, 32 or 64 rows. A paged ``ServingEngine`` on
    the card calls this at construction, so that another page size raises
    there and not mid-serve; the plain versions on the CPU take any page
    size. Returns the page size."""
    if page_size not in PAGE_SIZES:
        raise ValueError(
            f"the paged kernels (flash_fwd_paged, flash_bwd_dq_paged, "
            f"flash_bwd_dkv_paged, flash_decode_paged) take page sizes "
            f"{PAGE_SIZES} on the card, got {page_size}")
    return page_size


def bwd_tiles(head_dim: int) -> tuple[int, int]:
    """The fixed backward (block_q, block_k) for a head_dim: the forward's
    tiles, because one compiled layout serves the forward and the
    backward (``ops.flash_attention``); 64 x 64 fits shared memory for
    every head_dim the kernels take (fp32 166 KB, bf16 101 KB contiguous
    and 168 KB paged at d = 128)."""
    bq, bk = fwd_tiles(head_dim)
    for bf16, paged in ((False, False), (True, False), (True, True)):
        if attention_working_set_bytes(bq, bk, head_dim, bf16=bf16,
                                       paged=paged) > SMEM_PER_BLOCK:
            raise ValueError(f"backward tiles ({bq}, {bk}) exceed shared "
                             f"memory at head_dim {head_dim}")
    return bq, bk


def elt_bytes(dtype: str) -> int:
    """Bytes of one element of a config's dtype (``"bfloat16"`` 2,
    ``"float32"`` 4), as the reference's ``tuning._elt_bytes``."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}.get(str(dtype), 4)


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


def resolve_sp_strategy(chunk: int, prefix: int, head_dim: int, *,
                        heads_q: int = 1, heads_kv: int = 1, sp: int = 1,
                        dtype: str = "float32", layers: int = 1) -> dict:
    """The sequence-parallel prefill's K/V movement for one engine shape
    (DESIGN.md §14): both strategies costed against replicated prefill by
    ``io_model.sp_prefill_hbm_bytes`` at the forward kernel's q tile
    (``fwd_tiles``: 64 rows; the reference costs its own tuner's tile).
    ``heads_q`` / ``heads_kv`` are per tensor-parallel shard. Returns
    ``{"strategy", "costs", "block_q"}``: the strategy that costs less
    ("allgather" at sp <= 1, where none is used)."""
    block_q = fwd_tiles(head_dim)[0]
    costs = io_model.sp_prefill_hbm_bytes(
        chunk, prefix, head_dim, max(1, heads_q), max(1, heads_kv), sp,
        block_q=block_q, elt=elt_bytes(dtype), layers=max(1, layers))
    strategy = "allgather" if sp <= 1 else costs["best"]
    return {"strategy": strategy, "costs": costs, "block_q": block_q}


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


def check_decode_splits(num_splits: int) -> int:
    """The split counts the decode kernel (``flash_decode``,
    ``flash_decode_paged``) takes on the card: the splits of one sequence
    and kv head run as one thread-block cluster and merge there, and a
    portable cluster holds at most ``MAX_DECODE_SPLITS`` blocks. The
    resolvers never pick more (``TARGET_DECODE_SPLITS``); an explicit
    larger count raises here, before any launch. The plain versions on the
    CPU take any count. Returns the split count."""
    if not 1 <= num_splits <= MAX_DECODE_SPLITS:
        raise ValueError(
            f"the decode kernels (flash_decode, flash_decode_paged) merge "
            f"their splits in one thread-block cluster and take 1 to "
            f"{MAX_DECODE_SPLITS} splits on the card, got {num_splits}")
    return num_splits


def choose_decode_geometry(capacity: int, *,
                           target_splits: int = TARGET_DECODE_SPLITS,
                           pinned_splits: int | None = None
                           ) -> tuple[int, int]:
    """``(block_k, num_splits)`` for a contiguous cache of ``capacity``
    slots. The split-KV kernel reads every valid cache byte once whatever
    the block, so the objective is parallelism, then the block: among
    row-aligned divisors of the capacity no larger than the kernel's
    shared-memory tile (``DECODE_TILE``; the smallest aligned divisor when
    none is), maximize the split count (capped at ``target_splits``), then
    the block. Divisor-valid by construction. ``pinned_splits`` (an
    explicit split count with an auto block) constrains the search; no
    block honouring it is an error, never a silent clamp."""
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


def resolve_decode_geometry(capacity: int, block_k: int | None,
                            num_splits: int | None, *,
                            target_splits: int = TARGET_DECODE_SPLITS
                            ) -> tuple[int, int]:
    """Decode ``(block_k, num_splits)`` for a CONTIGUOUS cache (the paged
    cache resolves through ``resolve_paged_decode_splits``: its block is
    the page). Auto values are valid by construction; explicit ones are
    validated as in the JAX package (clamped to the cache, misalignment
    raises)."""
    from repro_torch.kernels.flash_decode import validate_decode_geometry
    if block_k is None:
        block_k, num_splits = choose_decode_geometry(
            capacity, target_splits=target_splits,
            pinned_splits=None if num_splits is None else int(num_splits))
    elif num_splits is None:
        block_k = min(int(block_k), capacity)
        nk = max(1, capacity // max(int(block_k), 1))
        num_splits = next(s for s in _divisors_desc(nk) if s <= target_splits)
    return validate_decode_geometry(capacity, int(block_k), int(num_splits))
