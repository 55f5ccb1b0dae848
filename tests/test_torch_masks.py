"""Mask IR parity: ``repro_torch.core.masks`` layouts equal the JAX
package's bit for bit over a sweep of MaskSpecs (static geometry, kv
padding tails, kv masks, packed segments, logical positions, sparse
patterns) and the paged builders. Inputs are made with numpy from a seed
and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro_torch.core import masks as TM

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


def _np(layout):
    if isinstance(layout, (JM.BlockLayout, TM.BlockLayout)):
        layout = layout.layout
    if isinstance(layout, torch.Tensor):
        return layout.cpu().numpy()
    return np.asarray(layout)


def _pair(spec_kw, arrays):
    """The same MaskSpec in both packages: numpy arrays become jnp / torch."""
    jspec = JM.MaskSpec(**spec_kw, **{k: jnp.asarray(v) for k, v in arrays.items()})
    tspec = TM.MaskSpec(**spec_kw, **{k: torch.as_tensor(v) for k, v in arrays.items()})
    return jspec, tspec


def _segments(rng, b, s):
    """(b, s) contiguous packed-segment ids with random boundaries."""
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), size=rng.integers(0, 4),
                                  replace=False))
        out[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return out


STATIC_CASES = [
    dict(),
    dict(causal=True),
    dict(causal=True, q_offset=24),
    dict(window=20, causal=True),
    dict(window=9, q_offset=40, causal=True),
    dict(causal=True, kv_valid_len=50),
    dict(kv_valid_len=33),
]


@pytest.mark.parametrize("kw", STATIC_CASES, ids=lambda kw: str(kw) or "full")
@pytest.mark.parametrize("blocks", [(16, 16), (8, 32), (32, 8)])
def test_static_layouts_bit_equal(kw, blocks):
    sq, sk = 64, 64 + kw.get("q_offset", 0)
    jspec, tspec = _pair(kw, {})
    jl = JM.compile_block_layout(jspec, sq, sk, *blocks)
    tl = TM.compile_block_layout(tspec, sq, sk, *blocks)
    assert tl.is_static
    np.testing.assert_array_equal(_np(tl), _np(jl))
    assert _np(tl).dtype == _np(jl).dtype


@pytest.mark.parametrize("seed", range(6))
def test_data_layouts_bit_equal(seed):
    """Random combinations of kv_mask / segments / positions / geometry."""
    rng = np.random.default_rng(seed)
    b, sq, sk, bq, bk = 2, 48, 64, 16, 8
    kw = {"causal": bool(rng.integers(2))}
    if rng.integers(2):
        kw["window"] = int(rng.integers(4, 40))
    arrays = {}
    if rng.integers(2):
        arrays["kv_mask"] = rng.random((b, sk)) > 0.3
    if seed % 2 == 0:
        arrays["q_segment_ids"] = _segments(rng, b, sq)
        arrays["kv_segment_ids"] = _segments(rng, b, sk)
    if seed % 3 != 2 and (kw["causal"] or "window" in kw):
        hist = rng.integers(0, 32, size=(b, 1))
        arrays["q_positions"] = (hist + np.arange(sq)).astype(np.int32)
        kv_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
        kv_pos[:, -5:] = TM.POS_PAD
        arrays["kv_positions"] = kv_pos
    else:
        kw["q_offset"] = sk - sq
    jspec, tspec = _pair(kw, arrays)
    jl = JM.compile_block_layout(jspec, sq, sk, bq, bk)
    tl = TM.compile_block_layout(tspec, sq, sk, bq, bk)
    np.testing.assert_array_equal(_np(tl), _np(jl))


def test_sparse_pattern_and_kv_mask_bit_equal():
    rng = np.random.default_rng(7)
    pattern = (rng.random((4, 4)) > 0.4).astype(np.uint8)
    kvm = rng.random((2, 64)) > 0.2
    for kw in ({"causal": True}, {}):
        jspec, tspec = _pair(dict(sparse_layout=pattern, **kw), {"kv_mask": kvm})
        np.testing.assert_array_equal(
            _np(TM.compile_block_layout(tspec, 64, 64, 16, 16)),
            _np(JM.compile_block_layout(jspec, 64, 64, 16, 16)))


@pytest.mark.parametrize("window", [None, 13])
def test_paged_builders_bit_equal(window):
    rng = np.random.default_rng(3)
    b, T, ps = 4, 6, 8
    table = rng.integers(0, 30, size=(b, T)).astype(np.int32)
    table[1, 3:] = -1
    table[3, :] = -1
    kv_len = np.array([1, 24, 48, 0], np.int32)
    jl = JM.paged_block_layout(jnp.asarray(kv_len), jnp.asarray(table), ps,
                               window=window)
    tl = TM.paged_block_layout(torch.as_tensor(kv_len), torch.as_tensor(table),
                               ps, window=window)
    np.testing.assert_array_equal(_np(tl), _np(jl))
    np.testing.assert_array_equal(
        TM.decode_kv_valid(torch.as_tensor(kv_len), T * ps,
                           window=window).numpy(),
        np.asarray(JM.decode_kv_valid(jnp.asarray(kv_len), T * ps,
                                      window=window)))
    layout = rng.integers(0, 4, size=(b, 3, T)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(TM.paged_prefill_block_layout(torch.as_tensor(layout),
                                          torch.as_tensor(table))),
        _np(JM.paged_prefill_block_layout(jnp.asarray(layout),
                                          jnp.asarray(table))))


def test_segment_helpers_equal():
    rng = np.random.default_rng(11)
    seg = _segments(rng, 3, 40)
    seg[1, 30:] = TM.SEG_PAD_Q
    np.testing.assert_array_equal(
        TM.segment_relative_positions(torch.as_tensor(seg)).numpy(),
        np.asarray(JM.segment_relative_positions(jnp.asarray(seg))))
    t = torch.as_tensor(seg)
    assert TM.resolve_segment_ids(t, None, None, 40, 40) == (t, t)
    with pytest.raises(ValueError):
        TM.resolve_segment_ids(t, t, t, 40, 40)
    with pytest.raises(ValueError):
        TM.resolve_segment_ids(t, None, None, 40, 41)
    assert (TM.NEG_INF, TM.POS_PAD, TM.SEG_PAD_Q, TM.SEG_PAD_KV) == \
        (JM.NEG_INF, JM.POS_PAD, JM.SEG_PAD_Q, JM.SEG_PAD_KV)
    assert (TM.BLOCK_SKIP, TM.BLOCK_FULL, TM.BLOCK_PARTIAL,
            TM.BLOCK_PARTIAL_DATA) == (JM.BLOCK_SKIP, JM.BLOCK_FULL,
                                       JM.BLOCK_PARTIAL, JM.BLOCK_PARTIAL_DATA)


def test_element_mask_matches():
    rng = np.random.default_rng(5)
    b, sq, sk = 2, 12, 20
    arrays = {"kv_mask": rng.random((b, sk)) > 0.3,
              "q_segment_ids": _segments(rng, b, sq),
              "kv_segment_ids": _segments(rng, b, sk)}
    jspec, tspec = _pair(dict(causal=True, window=6, q_offset=8), arrays)
    np.testing.assert_array_equal(tspec.element_mask(sq, sk).numpy(),
                                  np.asarray(jspec.element_mask(sq, sk)))


def test_maskspec_validation():
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TM.MaskSpec(q_positions=pos)
    with pytest.raises(ValueError):
        TM.MaskSpec(q_positions=pos, kv_positions=pos, kv_valid_len=4)
    with pytest.raises(ValueError):
        TM.compile_block_layout(
            TM.MaskSpec(causal=True, q_segment_ids=pos, kv_segment_ids=pos),
            8, 8, 3, 3)
