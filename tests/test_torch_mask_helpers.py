"""The element-mask helpers of ``repro_torch.core.masks`` bit-equal to the
reference's (``repro.core.masks``): ``causal_mask``,
``sliding_window_mask``, ``segment_mask`` and ``padding_mask_to_bias``
over a small grid of lengths, offsets, windows and segment patterns;
``MaskSpec.has_geometry`` / ``has_data`` and ``BlockLayout.density`` /
``skip_count`` / ``block_count`` of the same compiled layouts."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as JM
from repro_torch.core import masks as M

LENGTHS = [(1, 1), (5, 9), (16, 16), (7, 24), (33, 17)]
OFFSETS = [0, 3, 8]
WINDOWS = [1, 4, 16]


@pytest.mark.parametrize("q_len,k_len", LENGTHS)
@pytest.mark.parametrize("q_offset", OFFSETS)
def test_causal_mask(q_len, k_len, q_offset):
    got = M.causal_mask(q_len, k_len, q_offset).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JM.causal_mask(q_len, k_len, q_offset)))


@pytest.mark.parametrize("q_len,k_len", LENGTHS)
@pytest.mark.parametrize("q_offset,window",
                         list(itertools.product(OFFSETS, WINDOWS)))
def test_sliding_window_mask(q_len, k_len, q_offset, window):
    got = M.sliding_window_mask(q_len, k_len, window, q_offset).numpy()
    want = np.asarray(JM.sliding_window_mask(q_len, k_len, window, q_offset))
    np.testing.assert_array_equal(got, want)


SEGMENTS = {
    "one": ([[0] * 6], [[0] * 6]),
    "packed": ([[0, 0, 1, 1, 1, 2]], [[0, 0, 1, 1, 1, 2]]),
    "padded": ([[0, 0, 1, -1, -1, -1]], [[0, 0, 1, -2, -2, -2]]),
    "cross": ([[0, 1, 1], [2, 2, 2]], [[0, 0, 1, 1, 2], [2, 0, 2, 1, 2]]),
}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_segment_mask(name):
    q, kv = (np.asarray(a, np.int32) for a in SEGMENTS[name])
    got = M.segment_mask(torch.from_numpy(q), torch.from_numpy(kv))
    want = JM.segment_mask(jnp.asarray(q), jnp.asarray(kv))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_mask_to_bias(dtype):
    mask = np.random.default_rng(0).random((3, 11)) > 0.4
    got = M.padding_mask_to_bias(torch.from_numpy(mask),
                                 getattr(torch, dtype))
    want = JM.padding_mask_to_bias(jnp.asarray(mask), getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _specs(lib, q_len, k_len):
    """The same MaskSpecs in either package: geometry only, data only,
    both, and neither."""
    rng = np.random.default_rng(q_len * 100 + k_len)
    kvm = rng.random((2, k_len)) > 0.3
    seg = np.sort(rng.integers(0, 3, (2, q_len)), axis=1).astype(np.int32)
    as_arr = torch.from_numpy if lib is M else jnp.asarray
    return [lib.MaskSpec(causal=True),
            lib.MaskSpec(window=8, q_offset=k_len - q_len),
            lib.MaskSpec(kv_mask=as_arr(kvm)),
            lib.MaskSpec(kv_valid_len=k_len - 3),
            lib.MaskSpec(causal=True, kv_valid_len=k_len - 5),
            lib.MaskSpec(q_segment_ids=as_arr(seg),
                         kv_segment_ids=as_arr(seg)),
            lib.MaskSpec()]


@pytest.mark.parametrize("q_len,k_len", [(32, 32), (16, 48), (64, 64)])
def test_spec_terms_and_layout_counts(q_len, k_len):
    if q_len != k_len:
        jspecs = _specs(JM, q_len, k_len)[:5] + _specs(JM, q_len, k_len)[6:]
        specs = _specs(M, q_len, k_len)[:5] + _specs(M, q_len, k_len)[6:]
    else:
        jspecs, specs = _specs(JM, q_len, k_len), _specs(M, q_len, k_len)
    for spec, jspec in zip(specs, jspecs):
        assert spec.has_geometry == jspec.has_geometry
        assert spec.has_data == jspec.has_data
        for bq, bk in ((16, 16), (8, 16)):
            got = M.compile_block_layout(spec, q_len, k_len, bq, bk)
            want = JM.compile_block_layout(jspec, q_len, k_len, bq, bk)
            assert got.density() == want.density()
            assert got.skip_count() == want.skip_count()
            assert got.block_count() == want.block_count()
