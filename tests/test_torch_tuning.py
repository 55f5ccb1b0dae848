"""The attention kernels' tile helpers in ``repro_torch.kernels.tuning``
(pure Python, no card): shared memory of the forward's and the
backward's fp32 and bf16 bodies within a Hopper block for every head dim,
the pages one paged kv tile gathers, the page sizes the paged kernels
refuse (the check a paged engine on the card makes at construction), the
warp groups of a CTA, and the decode's split limit (one thread-block
cluster of at most 8 blocks) against the split resolvers."""

import pytest
import torch

from repro_torch.core import io_model
from repro_torch.kernels import ops, tuning


@pytest.mark.parametrize("d", tuning.KERNEL_HEAD_DIMS)
def test_fwd_smem_fits_a_block_at_every_head_dim(d):
    assert tuning.fwd_tiles(d) == (tuning.MAX_TILE, tuning.MAX_TILE)
    for bf16, paged in ((False, False), (True, False), (True, True)):
        assert tuning.fwd_smem_bytes(64, 64, d, bf16=bf16, paged=paged) \
            <= tuning.SMEM_PER_BLOCK


def test_fwd_smem_bf16_staging():
    """bf16: Q and, per warp group, two stages of K and V at 64 rows
    whatever the tiles; then per group and stage the kv_pos, kv_seg and
    kv_mask rows and the class table (128 entries a group)."""
    for d in tuning.KERNEL_HEAD_DIMS:
        for paged in (False, True):
            groups = tuning.fwd_kv_groups(d, paged)
            tiles = 2 * 64 * d * (1 + 2 * 2 * groups)
            rest = 4 * groups * (2 * 3 * 64 + 128)
            for bq, bk in ((8, 8), (24, 40), (64, 64)):
                assert tuning.fwd_smem_bytes(bq, bk, d, bf16=True,
                                             paged=paged) == tiles + rest
    assert tuning.fwd_smem_bytes(64, 64, 128, bf16=True) == 83_968
    assert tuning.fwd_smem_bytes(64, 64, 128, bf16=True, paged=True) == 151_552
    # fp32 keeps the scalar body's staging, which depends on the tiles
    assert tuning.fwd_smem_bytes(64, 64, 128) == 114_944
    assert tuning.fwd_smem_bytes(24, 40, 64) == 4 * (24 * 64 + 40 * 65
                                                     + 40 * 64 + 24 * 40)


def test_fwd_kv_groups():
    assert tuning.KERNEL_HEAD_DIMS == (16, 32, 64, 96, 128)
    assert [tuning.fwd_kv_groups(d, False) for d in tuning.KERNEL_HEAD_DIMS] \
        == [1, 1, 1, 1, 1]
    assert [tuning.fwd_kv_groups(d, True) for d in tuning.KERNEL_HEAD_DIMS] \
        == [3, 3, 3, 2, 2]


@pytest.mark.parametrize("page_size,pages", [(8, 8), (16, 4), (32, 2), (64, 1)])
def test_fwd_pages_per_tile(page_size, pages):
    assert tuning.fwd_pages_per_tile(page_size) == pages
    assert pages * page_size == tuning.MAX_TILE


@pytest.mark.parametrize("page_size", [0, 1, 4, 12, 24, 48, 96, 128])
def test_fwd_pages_per_tile_refuses_other_pages(page_size):
    with pytest.raises(ValueError, match="page sizes"):
        tuning.fwd_pages_per_tile(page_size)


@pytest.mark.parametrize("d", tuning.KERNEL_HEAD_DIMS)
def test_bwd_smem_fits_a_block_at_every_head_dim(d):
    assert tuning.bwd_tiles(d) == (tuning.MAX_TILE, tuning.MAX_TILE)
    for bf16, paged in ((False, False), (True, False), (True, True)):
        assert tuning.bwd_smem_bytes(64, 64, d, bf16=bf16, paged=paged) \
            <= tuning.SMEM_PER_BLOCK


def test_bwd_smem_bf16_staging():
    """bf16: whatever the tiles, dq stages Q', dO and per warp group two
    stages of K and V at 64 rows, then per group and stage three rows of
    kv terms and the class table; dkv stages K, V and two stages of Q' and
    dO at 64 rows, then five per-row words a stage, the class table and a
    4-word reduction; the block takes the larger of the two."""
    for d in tuning.KERNEL_HEAD_DIMS:
        dkv = 2 * 6 * 64 * d + 4 * (2 * 5 * 64 + 128 + 4)
        for paged in (False, True):
            groups = tuning.fwd_kv_groups(d, paged)   # the dq's groups
            dq = 2 * 64 * d * (2 + 2 * 2 * groups) + 4 * groups * (2 * 3 * 64
                                                                  + 128)
            for bq, bk in ((8, 8), (24, 40), (64, 64)):
                assert tuning.bwd_smem_bytes(bq, bk, d, bf16=True,
                                             paged=paged) == max(dq, dkv)
    assert tuning.bwd_smem_bytes(64, 64, 128, bf16=True) == 101_392
    assert tuning.bwd_smem_bytes(64, 64, 128, bf16=True, paged=True) == 167_936
    # fp32 keeps the scalar body's staging, which depends on the tiles
    assert tuning.bwd_smem_bytes(64, 64, 128) == 166_144
    assert tuning.bwd_smem_bytes(24, 40, 64) == max(
        4 * (2 * 24 * 64 + 2 * 40 * 65 + 24 * 40),
        4 * ((2 * 40 + 2 * 24) * 65 + 2 * 40 * 24 + 5 * 24))


@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
def test_check_page_size_takes_the_kernels_pages(page_size):
    assert tuning.check_page_size(page_size) == page_size


@pytest.mark.parametrize("page_size", [0, 4, 12, 48, 96, 128])
def test_check_page_size_refuses_other_pages(page_size):
    """The error names every paged kernel and the sizes they take."""
    with pytest.raises(ValueError) as err:
        tuning.check_page_size(page_size)
    msg = str(err.value)
    for kernel in ("flash_fwd_paged", "flash_bwd_dq_paged",
                   "flash_bwd_dkv_paged", "flash_decode_paged"):
        assert kernel in msg
    assert "(8, 16, 32, 64)" in msg and str(page_size) in msg


@pytest.mark.parametrize("num_splits", range(1, tuning.MAX_DECODE_SPLITS + 1))
def test_check_decode_splits_takes_a_cluster(num_splits):
    assert tuning.check_decode_splits(num_splits) == num_splits


@pytest.mark.parametrize("num_splits", [0, 9, 12, 16])
def test_check_decode_splits_refuses_more_than_a_cluster(num_splits):
    """The error names both decode kernels, the limit and the count."""
    with pytest.raises(ValueError) as err:
        tuning.check_decode_splits(num_splits)
    msg = str(err.value)
    assert "flash_decode" in msg and "flash_decode_paged" in msg
    assert "1 to 8 splits" in msg and str(num_splits) in msg


def test_decode_split_resolvers_stay_within_a_cluster():
    """Auto split counts never exceed the cluster limit, so only an
    explicit count can be refused on the card."""
    assert tuning.TARGET_DECODE_SPLITS <= tuning.MAX_DECODE_SPLITS
    for pages in range(1, 300):
        tuning.check_decode_splits(tuning.resolve_paged_decode_splits(pages))
    for cap in (8, 64, 96, 100, 1056, 2048, 4096, 32768):
        _, splits = tuning.resolve_decode_geometry(cap, None, None)
        tuning.check_decode_splits(splits)
        _, splits = tuning.resolve_decode_geometry(cap, 4, None)  # 4 | cap
        tuning.check_decode_splits(splits)


def test_pinned_zero_tile_raises():
    """A pinned 0 is refused, not taken as auto (``None`` is auto)."""
    q = torch.zeros(1, 2, 16, 16)
    for kw in (dict(block_q=0), dict(block_k=0), dict(block_q=0, block_k=32)):
        with pytest.raises(ValueError, match="rows"):
            ops.flash_attention(q, q, q, causal=True, **kw)
    kv_pos = torch.arange(16, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="rows"):
        ops.flash_prefill_paged(q, torch.zeros(2, 2, 8, 16),
                                torch.zeros(2, 2, 8, 16),
                                torch.tensor([[0, 1]], dtype=torch.int32),
                                q_positions=kv_pos, kv_positions=kv_pos,
                                block_q=0)


def test_default_budget_is_one_block():
    """The tuner's budget defaults to the shared memory one block may use,
    and the largest tiles fit it at every head dim, paged or not."""
    assert tuning.sram_budget() == io_model.DEFAULT_SRAM_BUDGET \
        == tuning.SMEM_PER_BLOCK
    for d in tuning.KERNEL_HEAD_DIMS:
        for dtype in ("float32", "bfloat16"):
            for paged in (False, True):
                cfg = tuning.choose_tile_config(4096, 4096, d, dtype=dtype,
                                                paged=paged)
                assert (cfg.block_q, cfg.block_k) == tuning.bwd_tiles(d)
