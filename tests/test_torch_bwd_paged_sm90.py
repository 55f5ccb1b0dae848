"""The paged backward pair at the tiles the sm90 body takes
(``csrc/flash_bwd_sm90.cu`` with Paged = true: 64-row q blocks, pages of 8
and 64 rows, head_dim 96 and 128, GQA 4 and 8), on the CPU against the JAX
package: the port's plain version (``flash_prefill_paged_backward_plain``,
the dense backward over the gathered pages and the fold into pool shape)
and the JAX ``flash_prefill_paged_backward`` (its Pallas dq and dkv
kernels in interpret mode, then the XLA scatter-add), fed the same numpy
inputs, residuals and compiled layout. Each row holds two q blocks; pages
are shared within a row and across rows, dead slots sit between documents
and after them, padded q rows have no key, and a window makes pages SKIP
inside page groups whose other pages run. Tolerance: gradients scaled by
their max, rtol 1e-4 / atol 1e-5 (fp32, summation order; the tolerance of
``tests/test_kernels_flash.py``). The kernel itself runs only on the card:
``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import tuning

torch.set_num_threads(1)

NAMES = ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions")
SQ, BLOCK_Q = 128, 64          # two q blocks per row

# name: (page, head_dim, hq, hkv, window)
CASES = {
    "page8_d96_gqa4_window": (8, 96, 4, 1, 24),
    "page8_d128_gqa8": (8, 128, 8, 1, None),
    "page64_d96_gqa4": (64, 96, 8, 2, None),
    "page64_d128_gqa8_window": (64, 128, 8, 1, 40),
}


def _case(name):
    """Row 0: document A (span 100, 50 chunk rows), a dead slot, document B
    (span 60, 30 rows); row 1: document C (span 120, 70 rows). A's, B's and
    C's first pages are one pool page; two or more dead slots end each row
    (T no multiple of the pages of a 64-key tile below page 64)."""
    ps, d, hq, hkv, window = CASES[name]
    rng = np.random.default_rng(len(name) + ps + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rows = [[(100, 50), (60, 30)], [(120, 70)]]
    npg = lambda span: -(-span // ps)  # noqa: E731
    g = tuning.fwd_pages_per_tile(ps)
    T = max(sum(npg(s) for s, _ in docs) + len(docs) - 1 for docs in rows) + 2
    while g > 1 and T % g == 0:
        T += 1
    num_pages = sum(npg(s) for docs in rows for s, _ in docs) + 4
    perm = rng.permutation(num_pages)
    page_list = np.full((2, T), -1, np.int32)
    kv_seg = np.full((2, T * ps), JM.SEG_PAD_KV, np.int32)
    kv_pos = np.full((2, T * ps), JM.POS_PAD, np.int32)
    q_seg = np.full((2, SQ), JM.SEG_PAD_Q, np.int32)
    q_pos = np.full((2, SQ), JM.POS_PAD, np.int32)
    nxt = 1
    for r, docs in enumerate(rows):
        slot = row = 0
        for s, (span, n) in enumerate(docs):
            np_ = npg(span)
            page_list[r, slot:slot + np_] = [perm[0], *perm[nxt:nxt + np_ - 1]]
            nxt += np_ - 1
            kv_seg[r, slot * ps:slot * ps + span] = s
            kv_pos[r, slot * ps:slot * ps + span] = np.arange(span)
            q_seg[r, row:row + n] = s
            q_pos[r, row:row + n] = np.arange(span - n, span)
            slot, row = slot + np_ + 1, row + n
    ids = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg, q_positions=q_pos,
               kv_positions=kv_pos)
    spec = JM.MaskSpec(causal=True, window=window, q_offset=0,
                       **{n: jnp.asarray(x) for n, x in ids.items()})
    layout = JM.compile_block_layout(spec, SQ, T * ps, BLOCK_Q, ps).as_array()
    layout = np.asarray(JM.paged_prefill_block_layout(layout,
                                                      jnp.asarray(page_list)))
    arrays = dict(q=f(2, hq, SQ, d), k_pool=f(hkv, num_pages, ps, d),
                  v_pool=f(hkv, num_pages, ps, d), page_list=page_list,
                  layout=layout, **ids)
    call = dict(scale=d ** -0.5, causal=True, window=window,
                block_q=BLOCK_Q)
    return arrays, f(2, hq, SQ, d), call


def _torch(arrays):
    return {n: torch.tensor(np.array(x)) for n, x in arrays.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_takes_the_sm90_body_and_its_edges(name):
    """Each case is a call the sm90 paged pair takes on the card, and holds
    what that body must get right: a page shared by several slots, dead
    slots (below page 64: inside a page group that runs), with a window a
    live slot SKIP for a q block that runs other pages (below page 64: in
    the same page group)."""
    arrays, _, call = _case(name)
    ps = arrays["k_pool"].shape[2]
    layout, page_list = arrays["layout"], arrays["page_list"]
    nq, T = layout.shape[1:]
    assert tfa.backward_body(on_card=True, dtype=torch.bfloat16,
                             head_dim=arrays["q"].shape[-1], block_q=BLOCK_Q,
                             block_k=ps, paged=True, nq=nq, nk=T) == "sm90"
    assert nq == 2
    live = page_list[page_list >= 0]
    assert len(live) > len(set(live.tolist()))           # a shared page
    g = tuning.fwd_pages_per_tile(ps)
    groups = -(-T // g)
    padded = np.full((2, nq, groups * g), JM.BLOCK_SKIP)
    padded[..., :T] = layout
    runs = (padded != JM.BLOCK_SKIP).reshape(2, nq, groups, g)
    dead = np.pad(page_list < 0, ((0, 0), (0, groups * g - T)),
                  constant_values=True).reshape(2, groups, g)
    skip_live = ~runs & ~dead[:, None]
    if g > 1:
        # a page group that runs, with a dead slot in it
        assert bool((runs.any(-1) & dead[:, None].any(-1)).any())
        if call["window"] is not None:
            # a live slot SKIP beside one that runs, in one (q block, group)
            assert bool((runs.any(-1) & skip_live.any(-1)).any())
    else:
        assert bool(dead[:, :T].any())
        if call["window"] is not None:
            assert bool((runs.any((-2, -1))[..., None, None] & skip_live).any())


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_backward_at_sm90_tiles_matches_jax(name):
    """(dq, dk_pool, dv_pool) of the port's plain paged backward against the
    JAX package's Pallas pair (interpret mode) and fold, from the same
    residuals (o, m, l) and layout; pages no slot names stay exactly
    zero."""
    arrays, do, call = _case(name)
    t = _torch(arrays)
    ids = {n: t[n] for n in NAMES}
    o, m, l = tfa.flash_prefill_paged_forward_plain(
        t["q"], t["k_pool"], t["v_pool"], t["page_list"], t["layout"],
        **call, **ids)
    got = tfa.flash_prefill_paged_backward_plain(
        t["q"], t["k_pool"], t["v_pool"], t["page_list"], o,
        torch.as_tensor(do), m, l, t["layout"], **call, **ids)
    j = {n: jnp.asarray(x) for n, x in arrays.items()}
    want = jfa.flash_prefill_paged_backward(
        j["q"], j["k_pool"], j["v_pool"], j["page_list"],
        *(jnp.asarray(x.numpy()) for x in (o, torch.as_tensor(do), m, l)),
        j["layout"], interpret=True, **call, **{n: j[n] for n in NAMES})
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=1e-4,
                                   atol=1e-5)
    named = set(arrays["page_list"][arrays["page_list"] >= 0].tolist())
    untouched = [p for p in range(arrays["k_pool"].shape[1]) if p not in named]
    assert untouched
    for g in got[1:]:
        assert torch.all(g[:, untouched] == 0)
