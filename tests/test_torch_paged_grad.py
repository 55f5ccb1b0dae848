"""The trainable paged prefill on the CPU against the JAX package: gradients
of ``ops.flash_prefill_paged`` (the paged dq / dkv kernels' plain
versions, then the fold of the packed dk / dv into pool shape) against
``jax.grad`` through the JAX op, whose Pallas forward and backward kernels
run in interpret mode, on the same numpy inputs. The case packs two
segments into one row and a third into another, shares one pool page
among all three (within a row and across rows), leaves dead slots, and
scrambles the page table. Tolerance: gradients scaled by their max, rtol
1e-4 / atol 1e-5; untouched pages' gradients exactly zero; the fold is
deterministic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import ops as jops
from repro_torch.core.attention import AttentionSpec, paged_prefill_attention
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

# One intra-op thread. With two, the first float32 torch.exp of a process
# that is split over both threads now and then computes the second
# thread's half at ~1.5e-4 relative accuracy instead of ~6e-8 (measured
# under CPU load: elements 4096..8191 of an 8192-element exp, in about 1
# of 60-150 fresh processes, never with one thread). The first call below
# then differs from the second: the bit-identity check's flake.
torch.set_num_threads(1)
NAMES = ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions")


def _case(seed, *, ps=8, d=16, hq=4, hkv=2, num_pages=24, T=8, sq=16):
    """Row 0: segments of 21 and 10 tokens (chunks 5, 4); row 1: one of 30
    (chunk 9). Every segment's first page is the same physical page."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    perm = rng.permutation(num_pages)
    b = 2
    page_list = np.full((b, T), -1, np.int32)
    kv_seg = np.full((b, T * ps), JM.SEG_PAD_KV, np.int32)
    kv_pos = np.full((b, T * ps), JM.POS_PAD, np.int32)
    q_seg = np.full((b, sq), JM.SEG_PAD_Q, np.int32)
    q_pos = np.full((b, sq), JM.POS_PAD, np.int32)
    nxt = 1
    for bi, (spans, chunks) in enumerate((([21, 10], [5, 4]), ([30], [9]))):
        slot = row = 0
        for s, (span, n) in enumerate(zip(spans, chunks)):
            np_ = -(-span // ps)
            page_list[bi, slot:slot + np_] = [perm[0], *perm[nxt:nxt + np_ - 1]]
            nxt += np_ - 1
            kv_seg[bi, slot * ps:slot * ps + span] = s
            kv_pos[bi, slot * ps:slot * ps + span] = np.arange(span)
            q_seg[bi, row:row + n] = s
            q_pos[bi, row:row + n] = np.arange(span - n, span)
            slot, row = slot + np_, row + n
    arrays = dict(q=f(b, hq, sq, d), k_pool=f(hkv, num_pages, ps, d),
                  v_pool=f(hkv, num_pages, ps, d), page_list=page_list,
                  q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                  q_positions=q_pos, kv_positions=kv_pos)
    return arrays, f(b, hq, sq, d)


def _assert_scaled_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               rtol=1e-4, atol=1e-5)


def _port_grads(case, do, **kw):
    leaves = [torch.tensor(case[n], requires_grad=True)
              for n in ("q", "k_pool", "v_pool")]
    o = tops.flash_prefill_paged(*leaves, torch.as_tensor(case["page_list"]),
                                 **{n: torch.as_tensor(case[n]) for n in NAMES},
                                 **kw)
    (o * torch.as_tensor(do)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("window,block_q", [(None, 8), (7, 8), (None, 16)])
def test_paged_prefill_grads_match_jax(window, block_q):
    case, do = _case(window or block_q)

    def loss(q, k, v):
        o = jops.flash_prefill_paged(
            q, k, v, jnp.asarray(case["page_list"]), window=window,
            block_q=block_q, kv_major=False, interpret=True,
            **{n: jnp.asarray(case[n]) for n in NAMES})
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(case[n]) for n in ("q", "k_pool", "v_pool")))
    got = _port_grads(case, do, window=window, block_q=block_q)
    for g, w in zip(got, want):
        _assert_scaled_close(g, w)
    live = set(case["page_list"][case["page_list"] >= 0].tolist())
    untouched = [p for p in range(case["k_pool"].shape[1]) if p not in live]
    for g in got[1:]:
        assert torch.all(g[:, untouched] == 0)
    # a second call is bit-identical (the fold is order-fixed)
    again = _port_grads(case, do, window=window, block_q=block_q)
    for name, a, b in zip(("dq", "dk_pool", "dv_pool"), got, again):
        assert torch.equal(a, b), (
            f"{name}: second call differs at {int((a != b).sum())} of "
            f"{a.numel()} entries, max |diff| "
            f"{float((a - b).abs().nan_to_num(float('inf')).max())}, NaN "
            f"{int(a.isnan().sum())} / {int(b.isnan().sum())}, torch threads "
            f"{torch.get_num_threads()}")


def test_paged_prefill_attention_passes_gradients():
    """core.attention.paged_prefill_attention with impl "pallas" (the op)
    and "reference" (gather + dense attention) give the same gradients."""
    case, do = _case(5)
    grads = {}
    for impl in ("pallas", "reference"):
        leaves = [torch.tensor(case[n], requires_grad=True)
                  for n in ("q", "k_pool", "v_pool")]
        o = paged_prefill_attention(
            *leaves, torch.as_tensor(case["page_list"]),
            AttentionSpec(impl=impl),
            **{n: torch.as_tensor(case[n]) for n in NAMES})
        live = torch.as_tensor(case["q_segment_ids"]) >= 0
        ((o * torch.as_tensor(do)) * live[:, None, :, None]).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for a, b in zip(grads["pallas"], grads["reference"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_fold_packed_to_pool_sums_shared_pages_in_fixed_order():
    """The fold equals a plain index_add_ over live slots, drops dead ones,
    and repeated pages (three sharers) get the sum."""
    rng = np.random.default_rng(0)
    b, hkv, T, ps, d, P = 3, 2, 4, 8, 16, 10
    packed = torch.as_tensor(
        rng.standard_normal((b, hkv, T * ps, d)).astype(np.float32))
    page_list = torch.tensor([[3, 7, -1, 3], [3, 1, 2, -1], [9, -1, -1, -1]],
                             dtype=torch.int32)
    got = tfa.fold_packed_to_pool(packed, page_list, P)
    want = torch.zeros((hkv, P, ps, d))
    src = packed.reshape(b, hkv, T, ps, d)
    for bi in range(b):
        for t in range(T):
            p = int(page_list[bi, t])
            if p >= 0:
                want[:, p] += src[bi, :, t]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.all(got[:, [0, 4, 5, 6, 8]] == 0)
    assert torch.equal(got, tfa.fold_packed_to_pool(packed, page_list, P))
