"""Hopper tile choice for the hand-written attention kernels.

The JAX package's tuner (analytic SRAM-budget chooser + empirical
autotuner, ``repro.kernels.tuning``) is not ported yet. This module holds
the small part the serving path needs:

  * ``round_block`` — clamp a block to a sequence without emitting an
    unaligned tile (rows in multiples of ``ROW_ALIGN``; the caller pads);
  * ``fwd_tiles`` / ``bwd_tiles`` — one fixed (block_q, block_k) per
    head_dim whose shared-memory footprint in ``csrc/flash_fwd.cu`` /
    ``csrc/flash_bwd.cu`` fits a Hopper block;
  * ``resolve_paged_decode_splits`` — split-KV parallelism for paged decode
    with the divisor rule of ``flash_decode.validate_paged_decode_geometry``.
"""

from __future__ import annotations

ROW_ALIGN = 8               # tile rows: multiple of 8 (one mma.sync m-tile)
MAX_TILE = 64               # csrc/flash_fwd.cu MAX_BQ / MAX_BK
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
TARGET_DECODE_SPLITS = 8    # split-KV parallelism target
SMEM_PER_BLOCK = 232_448    # Hopper: bytes of shared memory one block may use


def round_block(requested: int, seq_len: int) -> int:
    """Clamp a block size to a sequence WITHOUT producing an unaligned
    tile: cap at the sequence rounded UP to ``ROW_ALIGN`` (the caller pads
    the operand to a block multiple) and round down to ``ROW_ALIGN``,
    floor ``ROW_ALIGN``."""
    cap = -(-max(seq_len, 1) // ROW_ALIGN) * ROW_ALIGN
    blk = min(int(requested), cap)
    blk = max(ROW_ALIGN, (blk // ROW_ALIGN) * ROW_ALIGN)
    return min(blk, cap)


def fwd_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Dynamic shared memory of one flash_fwd block (fp32 staging): the q
    tile, the K tile padded by one column (bank-conflict-free row dots),
    the V tile and the P tile."""
    return 4 * (block_q * head_dim + block_k * (head_dim + 1)
                + block_k * head_dim + block_q * block_k)


def fwd_tiles(head_dim: int) -> tuple[int, int]:
    """The fixed (block_q, block_k) for a head_dim: 64 x 64 fits shared
    memory for every head_dim the kernel takes (115 KB at d = 128)."""
    bq = bk = MAX_TILE
    assert fwd_smem_bytes(bq, bk, max(KERNEL_HEAD_DIMS)) <= SMEM_PER_BLOCK
    return bq, bk


def bwd_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Dynamic shared memory of the larger of the two backward blocks
    (fp32 staging). dq: q and dO tiles, K and V tiles padded by one
    column, the dS tile. dkv: K, V, q and dO tiles padded by one column,
    the (P∘Z)ᵀ and dSᵀ tiles, and five per-row vectors (m, l, D, position,
    segment)."""
    dq = 4 * (2 * block_q * head_dim + 2 * block_k * (head_dim + 1)
              + block_q * block_k)
    dkv = 4 * ((2 * block_k + 2 * block_q) * (head_dim + 1)
               + 2 * block_k * block_q + 5 * block_q)
    return max(dq, dkv)


def bwd_tiles(head_dim: int) -> tuple[int, int]:
    """The fixed backward (block_q, block_k) for a head_dim: the forward's
    tiles, because one compiled layout serves the forward and the
    backward (``ops.flash_attention``); 64 x 64 fits shared memory for
    every head_dim the kernels take (166 KB at d = 128)."""
    bq, bk = fwd_tiles(head_dim)
    if bwd_smem_bytes(bq, bk, head_dim) > SMEM_PER_BLOCK:
        raise ValueError(f"backward tiles ({bq}, {bk}) exceed shared memory "
                         f"at head_dim {head_dim}")
    return bq, bk


def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


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
