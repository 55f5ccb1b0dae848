"""Segment-aware packed (varlen) attention of the port against a
per-document oracle, on the CPU (port of ``tests/test_packed_attention.py``
to the port's attention dispatch): forward and all three gradients across
causal, non-causal, GQA and window, through ``kernels.ops.flash_attention``
(the kernels' plain versions on CPU tensors) and ``ref.chunked_attention``;
dropout against the JAX package's packed oracle with the same seed;
padding sentinels; the dispatch's three impls; the segment helpers.

The oracle is the JAX package's plain ``standard_attention`` run on each
document slice alone (``jax.grad`` of it for the gradients), fed the same
numpy inputs. Tolerances are the reference test's: outputs rtol/atol
1e-5, gradients 1e-5 once scaled by their max |.|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import segment_mask as jax_segment_mask
from repro.kernels.ref import standard_attention as jax_standard_attention
from repro_torch.core.attention import AttentionSpec, attention
from repro_torch.core.masks import (element_mask, segment_ids_from_boundaries,
                                    segment_relative_positions)
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import chunked_attention

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_close_normalized(a, b, name):
    scale = float(np.max(np.abs(b))) or 1.0
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               err_msg=name, **TOL)


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _t(*arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


def _segments(doc_lens: list[list[int]]) -> np.ndarray:
    """Per-row document lengths -> (b, s) int32 segment ids."""
    return np.stack([np.concatenate([np.full(n, i, np.int32)
                                     for i, n in enumerate(lens)])
                     for lens in doc_lens])


def _spans(seg_row):
    s = len(seg_row)
    bounds = [0] + [i for i in range(1, s) if seg_row[i] != seg_row[i - 1]] + [s]
    return list(zip(bounds[:-1], bounds[1:]))


def per_document_attention(q, k, v, seg, **kw):
    """Oracle: the JAX package's standard attention on each document
    slice alone."""
    out = np.zeros(q.shape, np.float32)
    for r in range(q.shape[0]):
        for a, b in _spans(seg[r]):
            out[r:r + 1, :, a:b] = jax_standard_attention(
                q[r:r + 1, :, a:b], k[r:r + 1, :, a:b], v[r:r + 1, :, a:b], **kw)
    return out


def per_document_grads(q, k, v, seg, **kw):
    def loss(q, k, v):
        total = 0.0
        for r in range(q.shape[0]):
            for a, b in _spans(seg[r]):
                o = jax_standard_attention(q[r:r + 1, :, a:b], k[r:r + 1, :, a:b],
                                           v[r:r + 1, :, a:b], **kw)
                total = total + (o.astype(jnp.float32) ** 2).sum()
        return total
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


def _grads(fn, q, k, v):
    tq, tk, tv = _t(q, k, v, grad=True)
    (fn(tq, tk, tv) ** 2).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


DOCS = [[30, 40, 30], [55, 45]]          # two rows, different layouts


@pytest.mark.parametrize("impl,kw", [
    ("pallas_causal", dict(causal=True)),
    ("pallas_noncausal", dict(causal=False)),
    ("pallas_window", dict(causal=True, window=16)),
    ("chunked_causal", dict(causal=True)),
    ("chunked_noncausal", dict(causal=False)),
    ("chunked_window", dict(causal=True, window=16)),
])
def test_packed_fwd_matches_per_document(impl, kw):
    q, k, v = _qkv(0, 2, 4, 4, 100, 32)
    seg = _segments(DOCS)
    ref = per_document_attention(q, k, v, seg, **kw)
    tseg = torch.as_tensor(seg)
    if impl.startswith("pallas"):
        o = flash_attention(*_t(q, k, v), segment_ids=tseg, block_q=32,
                            block_k=32, **kw)
    else:
        o = chunked_attention(*_t(q, k, v), segment_ids=tseg, chunk_size=32,
                              **kw)
    np.testing.assert_allclose(o.numpy(), ref, **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
def test_packed_gqa_fwd_and_grads(hq, hkv):
    q, k, v = _qkv(1, 2, hq, hkv, 96, 32)
    seg = _segments([[20, 50, 26], [64, 32]])
    tseg = torch.as_tensor(seg)

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=True, segment_ids=tseg,
                               block_q=32, block_k=32)

    ref = per_document_attention(q, k, v, seg, causal=True)
    np.testing.assert_allclose(fn(*_t(q, k, v)).numpy(), ref, **TOL)
    gr = per_document_grads(q, k, v, seg, causal=True)
    for name, a, b in zip("qkv", _grads(fn, q, k, v), gr):
        _assert_close_normalized(a, b, f"d{name}")


@pytest.mark.parametrize("path", ["pallas", "chunked"])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=24),
                                dict(causal=False)])
def test_packed_grads_match_per_document(path, kw):
    q, k, v = _qkv(2, 2, 2, 2, 80, 16)
    seg = _segments([[25, 55], [40, 24, 16]])
    tseg = torch.as_tensor(seg)

    if path == "pallas":
        def fn(q, k, v):
            return flash_attention(q, k, v, segment_ids=tseg, block_q=32,
                                   block_k=32, **kw)
    else:
        def fn(q, k, v):
            return chunked_attention(q, k, v, segment_ids=tseg,
                                     chunk_size=32, **kw)
    gr = per_document_grads(q, k, v, seg, **kw)
    for name, a, b in zip("qkv", _grads(fn, q, k, v), gr):
        _assert_close_normalized(a, b, f"d{name}")


def test_packed_dropout_matches_oracle_and_masks_cross_segment():
    """Dropout hashes GLOBAL packed coordinates, so the oracle is the JAX
    package's packed standard attention with the same segment ids and
    seed (the keep mask is bit-equal across the packages)."""
    q, k, v = _qkv(3, 2, 2, 2, 64, 16)
    seg = _segments([[20, 44], [30, 34]])
    tseg = torch.as_tensor(seg)
    kw = dict(causal=True, dropout_p=0.2, dropout_seed=7)
    o = flash_attention(*_t(q, k, v), segment_ids=tseg, block_q=32,
                        block_k=32, **kw)
    o_ref = jax_standard_attention(*map(jnp.asarray, (q, k, v)),
                                   segment_ids=jnp.asarray(seg), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-3,
                               atol=2e-5)
    tq = torch.tensor(q, requires_grad=True)
    (flash_attention(tq, *_t(k, v), segment_ids=tseg, block_q=32, block_k=32,
                     **kw) ** 2).sum().backward()
    g2 = jax.grad(lambda a: (jax_standard_attention(
        a, jnp.asarray(k), jnp.asarray(v), segment_ids=jnp.asarray(seg),
        **kw) ** 2).sum())(jnp.asarray(q))
    scale = float(jnp.max(jnp.abs(g2)))
    np.testing.assert_allclose(tq.grad.numpy() / scale, np.asarray(g2) / scale,
                               rtol=1e-4, atol=1e-5)


def test_packed_padding_sentinels():
    """Sequence length not a block multiple: padded q rows are fully masked
    (distinct q/kv pad sentinels), so outputs match the unpadded oracle."""
    q, k, v = _qkv(4, 1, 2, 2, 70, 16)          # 70 % 32 != 0
    seg = _segments([[30, 40]])
    o = flash_attention(*_t(q, k, v), causal=True,
                        segment_ids=torch.as_tensor(seg), block_q=32,
                        block_k=32)
    ref = per_document_attention(q, k, v, seg, causal=True)
    np.testing.assert_allclose(o.numpy(), ref, **TOL)
    assert not torch.isnan(o).any()


@pytest.mark.parametrize("causal", [True, False])
def test_dispatch_segment_ids_all_impls_agree(causal):
    q, k, v = _qkv(5, 2, 4, 2, 64, 16)
    seg = torch.as_tensor(_segments([[16, 48], [40, 24]]))
    outs = {}
    for impl in ("pallas", "chunked", "reference"):
        spec = AttentionSpec(impl=impl, causal=causal, block_q=32, block_k=32)
        outs[impl] = attention(*_t(q, k, v), spec, segment_ids=seg).numpy()
    np.testing.assert_allclose(outs["pallas"], outs["reference"], **TOL)
    np.testing.assert_allclose(outs["chunked"], outs["reference"], **TOL)
    ref = per_document_attention(q, k, v, seg.numpy(), causal=causal)
    np.testing.assert_allclose(outs["reference"], ref, **TOL)


def test_segment_helpers():
    boundary = np.array([[False, False, True, False, True, False]])
    seg = segment_ids_from_boundaries(boundary)
    np.testing.assert_array_equal(seg, [[0, 0, 1, 1, 2, 2]])
    pos = segment_relative_positions(torch.as_tensor(seg)).numpy()
    np.testing.assert_array_equal(pos, [[0, 1, 0, 1, 0, 1]])
    tseg = torch.as_tensor(seg)
    m = element_mask(None, None, q_seg=tseg[:, None, :, None],
                     kv_seg=tseg[:, None, None, :])
    want = np.asarray(jax_segment_mask(jnp.asarray(seg), jnp.asarray(seg)))
    np.testing.assert_array_equal(m.numpy(), want)
    m = m[0, 0]
    assert m[0, 1] and not m[0, 2] and m[2, 3] and not m[3, 4]
