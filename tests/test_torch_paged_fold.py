"""The fold of the paged dkv kernel's packed rows into pool shape, on the
CPU: the order that ``flash_bwd_fold_paged`` follows on the card
(``flash_attention.fold_order``, a stable sort of the page list on its
device), applied here in plain
PyTorch one slot at a time, is bit-equal to ``fold_packed_to_pool`` (the
fold kernel's plain version) and within 1e-6 of the JAX package's
scatter-add (``jnp.zeros(...).at[:, pages].add(..., mode="drop")``,
``repro.kernels.flash_attention`` l.924-933) in fp32. The cases share pages
within a row and across rows, leave dead slots and pages no slot names.
Also: the bf16 paged backward refuses a page size its 64-key tiles cannot
gather whole, before any launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


def _case(seed, b, hkv, T, ps, d, num_pages):
    """Random packed rows and a page list: one page is named twice in row 0
    and once in every other row, pages repeat at random, each row has a
    dead slot, and a third of the pool is never named."""
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((b, hkv, T * ps, d)).astype(np.float32)
    named = rng.permutation(2 * num_pages // 3)
    page_list = np.empty((b, T), np.int32)
    for r in range(b):
        page_list[r] = rng.choice(named, size=T)
    shared = int(named[0])
    page_list[:, 0] = shared                    # across rows
    page_list[0, T - 1] = shared                # within a row
    page_list[np.arange(b), 1 + np.arange(b) % (T - 2)] = -1
    return packed, page_list


def _fold_in_order(packed, page_list, num_pages):
    """The fold kernel's arithmetic in plain PyTorch: for each (page, slot)
    in the sorted order, add the slot's rows to its page in fp32, dead
    slots (page == num_pages) dropped."""
    b, hkv, rows, d = packed.shape
    T = page_list.shape[1]
    n, ps = b * T, rows // T
    src = packed.reshape(b, hkv, T, ps, d).transpose(1, 2).reshape(n, hkv,
                                                                   ps, d)
    out = torch.zeros((hkv, num_pages, ps, d))
    pages, slots = tfa.fold_order(page_list, num_pages)
    for page, slot in zip(pages.tolist(), slots.tolist()):
        if page < num_pages:
            out[:, page] += src[slot]
    return out


def _jax_fold(packed, page_list, num_pages):
    b, hkv, rows, d = packed.shape
    T = page_list.shape[1]
    ps = rows // T
    pages = jnp.where(page_list >= 0, page_list, num_pages).astype(jnp.int32)
    src = jnp.asarray(packed).reshape(b, hkv, T, ps, d).transpose(1, 0, 2, 3,
                                                                 4)
    return np.asarray(jnp.zeros((hkv, num_pages, ps, d), jnp.float32)
                      .at[:, pages].add(src, mode="drop"))


@pytest.mark.parametrize("b,hkv,T,ps,d,num_pages", [
    (2, 2, 6, 8, 16, 12), (3, 1, 5, 16, 8, 9), (4, 3, 7, 4, 32, 30)])
def test_fold_order_matches_fold_and_jax_scatter_add(b, hkv, T, ps, d,
                                                     num_pages):
    packed_np, page_list_np = _case(b + T, b, hkv, T, ps, d, num_pages)
    packed = torch.as_tensor(packed_np)
    page_list = torch.as_tensor(page_list_np)
    got = _fold_in_order(packed, page_list, num_pages)
    want = tfa.fold_packed_to_pool(packed, page_list, num_pages)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(),
                               _jax_fold(packed_np, page_list_np, num_pages),
                               rtol=0, atol=1e-6)
    named = set(page_list_np[page_list_np >= 0].tolist())
    unnamed = [p for p in range(num_pages) if p not in named]
    assert unnamed and torch.all(got[:, unnamed] == 0)


def test_fold_order_groups_each_page_in_slot_order():
    """Slots sort by page, then by (b, t); dead slots come last."""
    page_list = torch.tensor([[3, -1, 0, 3], [0, 3, -1, 2]], dtype=torch.int32)
    pages, slots = tfa.fold_order(page_list, 5)
    assert pages.tolist() == [0, 0, 2, 3, 3, 3, 5, 5]
    assert slots.tolist() == [2, 4, 7, 0, 3, 5, 1, 6]
    assert pages.dtype == torch.int32 and slots.dtype == torch.int64


@pytest.mark.parametrize("page_size", [24, 12, 128])
def test_bf16_paged_backward_refuses_other_page_sizes(page_size):
    """The check runs before any launch (here on the CPU: ``prepare_backward``
    raises before it would ask for a stream)."""
    b, hq, hkv, sq, d, T = 1, 2, 1, 32, 64, 2
    bf16 = torch.bfloat16
    q = torch.zeros((b, hq, sq, d), dtype=bf16)
    pool = torch.zeros((hkv, 4, page_size, d), dtype=bf16)
    stats = torch.zeros((b, hq, sq))
    with pytest.raises(ValueError, match="page sizes"):
        tfa.prepare_backward(
            q, pool, pool, q, q, stats, stats, None,
            torch.ones((b, 1, T), dtype=torch.int32), scale=0.125,
            causal=False, window=None, q_offset=0, block_q=sq,
            block_k=page_size, page_list=torch.zeros((b, T), dtype=torch.int32))
