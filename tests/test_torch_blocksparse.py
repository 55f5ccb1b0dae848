"""Block-sparse FlashAttention (paper §3.3, Alg. 5) on the CPU, against the
JAX package: the port's ``ops.flash_attention(block_layout=...)`` (its
kernels' plain versions) against the reference's in interpret mode, on
the same numpy inputs made from a seed, and the port's mask functions
against the reference's.

  * ``butterfly_block_layout`` (causal and not, square and not),
    ``layout_density`` and ``layout_skip_rate`` bit-equal to the
    reference's, and ``layout_to_element_mask`` equal to it with a base
    mask, a data mask and 4-D (b, 1, q, k) masks;
  * the forward at the butterfly layout, causal and not (a FULL block
    above the diagonal runs unmasked: the pattern is authoritative over
    the geometry), and at the causal layout, o within atol 1e-5 and equal
    to the dense oracle over ``layout_to_element_mask``;
  * the gradients (scaled by their max, rtol 1e-4 / atol 1e-5), GQA 2:1;
  * a layout row of SKIP blocks gives zero rows, not NaN;
  * a ``kv_mask`` turns FULL blocks it cuts into PARTIAL_DATA, which apply
    only the data terms (forward and gradients);
  * a 128-block pattern (the paper's block) is refined into the kernels'
    64-row tiles, each class repeated over its sub-tiles, with the same
    element mask and the same outputs as the reference at 128, also over a
    padded tail (510 rows in 128-row blocks); a 96-block
    pattern runs on the CPU as in the reference, and ``sparse_tile``
    refuses it for the card;
  * ``AttentionSpec(impl="block_sparse")`` requires a layout and equals the
    ``pallas`` path with it; ``apply_attention`` threads the layout
    through, against the reference's attention layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import masks as JM
from repro.kernels import ops as jops
from repro.models import attention_layer as jattn
from repro_torch.configs import reduced_config
from repro_torch.core import masks as TM
from repro_torch.core.attention import AttentionSpec, attention
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tuning
from repro_torch.models import attention_layer as tattn

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-5


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return f(b, hq, s, d), f(b, hkv, s, d), f(b, hkv, s, d)


def _both(q, k, v, layout, **kw):
    """o of the port and of the reference at ``layout``; kwargs go to
    both (a ``kv_mask`` as numpy)."""
    kvm = kw.pop("kv_mask", None)
    to = tops.flash_attention(
        *map(torch.as_tensor, (q, k, v)), block_layout=layout,
        kv_mask=None if kvm is None else torch.as_tensor(kvm), **kw)
    jo = jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_layout=layout,
        kv_mask=None if kvm is None else jnp.asarray(kvm), **kw)
    return to, np.asarray(jo)


def _grads(q, k, v, layout, **kw):
    """(dq, dk, dv) of sum(o**2) on both sides."""
    kvm = kw.pop("kv_mask", None)
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    o = tops.flash_attention(
        *leaves, block_layout=layout,
        kv_mask=None if kvm is None else torch.as_tensor(kvm), **kw)
    tg = torch.autograd.grad((o ** 2).sum(), leaves)
    jkvm = None if kvm is None else jnp.asarray(kvm)
    jg = jax.grad(lambda q, k, v: (jops.flash_attention(
        q, k, v, block_layout=layout, kv_mask=jkvm, **kw) ** 2).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return tg, jg


def _masked_attention(q, k, v, mask):
    """The dense oracle: softmax over the allowed pairs of ``mask``."""
    q, k, v = map(torch.as_tensor, (q, k, v))
    rep = q.shape[1] // k.shape[1]
    k, v = tref.repeat_kv(k, rep), tref.repeat_kv(v, rep)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _close_scaled(tg, jg):
    for name, a, b in zip("qkv", tg, jg):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the mask functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dims", [(256, 256, 64, 64), (512, 512, 128, 128),
                                  (4096, 4096, 128, 128),
                                  (320, 512, 64, 64), (512, 192, 64, 32)])
def test_butterfly_layout_and_density_bit_equal_reference(dims, causal):
    ours = TM.butterfly_block_layout(*dims, causal=causal)
    ref = JM.butterfly_block_layout(*dims, causal=causal)
    assert ours.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    assert TM.layout_density(ours) == JM.layout_density(ref)
    assert TM.layout_skip_rate(ours) == JM.layout_skip_rate(ref)
    assert 0 < TM.layout_density(ours) < 1


def test_sparse_layout_is_authoritative_over_geometry():
    """The case of the reference's mask-IR test: the pattern compiles as
    it is under causal geometry; a kv_mask demotes FULL to PARTIAL_DATA
    and never drops validity; density of a compiled BlockLayout."""
    pattern = TM.butterfly_block_layout(256, 256, 64, 64)
    spec = TM.MaskSpec(causal=True, sparse_layout=pattern)
    layout = TM.compile_block_layout(spec, 256, 256, 64, 64)
    np.testing.assert_array_equal(layout.layout, pattern)
    assert pattern[0, 2] == TM.BLOCK_FULL       # above the diagonal
    kvm = torch.as_tensor(np.arange(256)[None, :] < 200)
    spec2 = TM.MaskSpec(causal=True, sparse_layout=pattern, kv_mask=kvm)
    lay2 = TM.compile_block_layout(spec2, 256, 256, 64, 64)
    jlay2 = JM.compile_block_layout(
        JM.MaskSpec(causal=True, sparse_layout=pattern,
                    kv_mask=jnp.asarray(kvm.numpy())), 256, 256, 64, 64)
    np.testing.assert_array_equal(lay2.layout.numpy(), np.asarray(jlay2.layout))
    assert lay2.layout[0, 0, 0] == TM.BLOCK_FULL
    assert (lay2.layout[0, :, 3][torch.as_tensor(pattern[:, 3]) != 0]
            == TM.BLOCK_PARTIAL_DATA).all()
    assert TM.layout_density(lay2) == JM.layout_density(jlay2)
    with pytest.raises(ValueError, match="sparse_layout cannot govern"):
        pos = torch.zeros((1, 256), dtype=torch.int32)
        TM.MaskSpec(causal=True, sparse_layout=pattern, q_positions=pos,
                    kv_positions=pos)


def test_layout_to_element_mask_matches_reference():
    """Static and batched layouts, a 2-D base mask, a 4-D (b, 1, q, k)
    data mask, PARTIAL_DATA blocks."""
    s, bq = 128, 32
    rng = np.random.default_rng(5)
    static = rng.integers(0, 4, (4, 4)).astype(np.uint8)
    batched = rng.integers(0, 4, (2, 4, 4)).astype(np.int32)
    base = np.tril(np.ones((s, s), bool))
    data = rng.random((2, 1, s, s)) > 0.3
    for lay, kw in ((static, {}), (static, {"base": base}),
                    (batched, {"base": base}),
                    (batched, {"base": data, "data": data[:, :, ::-1]})):
        tb = kw.get("base")
        td = kw.get("data")
        ours = TM.layout_to_element_mask(
            lay, bq, bq, s, s,
            base_mask=None if tb is None else torch.as_tensor(tb.copy()),
            data_mask=None if td is None else torch.as_tensor(td.copy()))
        ref = JM.layout_to_element_mask(
            lay, bq, bq, s, s,
            base_mask=None if tb is None else jnp.asarray(tb),
            data_mask=None if td is None else jnp.asarray(td))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the forward and backward through the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder,causal", [
    (TM.butterfly_block_layout, False),
    (lambda *a: TM.butterfly_block_layout(*a, causal=True), True),
    (TM.causal_block_layout, True),
])
def test_blocksparse_forward_matches_reference(builder, causal):
    s, bq = 256, 64
    q, k, v = _qkv(0, 2, 2, 2, s, 16)
    layout = builder(s, s, bq, bq)
    to, jo = _both(q, k, v, layout, causal=causal)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    base = TM.MaskSpec(causal=True).element_mask(s, s) if causal else None
    emask = TM.layout_to_element_mask(layout, bq, bq, s, s, base_mask=base)
    want = _masked_attention(q, k, v, emask)
    np.testing.assert_allclose(to.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_full_block_above_the_diagonal_runs_unmasked():
    """A pattern FULL everywhere under causal=True attends every key: the
    output is non-causal attention, on both sides."""
    s = 128
    q, k, v = _qkv(7, 1, 2, 2, s, 16)
    layout = np.ones((2, 2), np.uint8)
    to, jo = _both(q, k, v, layout, causal=True)
    dense = _masked_attention(q, k, v, torch.ones((s, s), dtype=torch.bool))
    np.testing.assert_allclose(to.numpy(), dense.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)


def test_blocksparse_grads_match_reference():
    s, bq = 256, 64
    q, k, v = _qkv(1, 1, 4, 2, s, 32)
    layout = TM.butterfly_block_layout(s, s, bq, bq, causal=True)
    tg, jg = _grads(q, k, v, layout, causal=True)
    _close_scaled(tg, jg)


def test_blocksparse_skips_zero_blocks_output():
    """Rows whose layout row is all SKIP produce zeros, not NaN."""
    s, bq = 256, 64
    q, k, v = _qkv(2, 1, 1, 1, s, 16)
    layout = np.zeros((4, 4), np.uint8)
    layout[0, 0] = 1
    to, jo = _both(q, k, v, layout)
    assert not bool(torch.isnan(to).any())
    np.testing.assert_allclose(to[:, :, bq:].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_partial_data_with_kv_mask(causal):
    """A kv_mask cutting FULL blocks makes them PARTIAL_DATA: only the data
    terms apply (geometry stays overridden); forward and gradients."""
    s, bq = 256, 64
    q, k, v = _qkv(3, 2, 2, 1, s, 16)
    rng = np.random.default_rng(3)
    kvm = rng.random((2, s)) > 0.2
    kvm[:, 200:] = False
    layout = TM.butterfly_block_layout(s, s, bq, bq, causal=causal)
    compiled = TM.compile_block_layout(
        TM.MaskSpec(causal=causal, sparse_layout=layout,
                    kv_mask=torch.as_tensor(kvm)), s, s, bq, bq)
    assert (compiled.layout == TM.BLOCK_PARTIAL_DATA).any()
    to, jo = _both(q, k, v, layout, causal=causal, kv_mask=kvm)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    tg, jg = _grads(q, k, v, layout, causal=causal, kv_mask=kvm)
    _close_scaled(tg, jg)


@pytest.mark.parametrize("causal", [False, True])
def test_128_blocks_refine_into_kernel_tiles(causal):
    """The paper's 128-row blocks: the port cuts each into 2 x 2 tiles of
    64 (the kernels' largest), the classes repeated; the element mask is
    unchanged, and o and the gradients agree with the reference at 128
    blocks, with a kv_mask too."""
    s, blk = 512, 128
    layout = TM.butterfly_block_layout(s, s, blk, blk, causal=causal)
    assert tuning.sparse_tile(blk, on_card=True) == (64, 2)
    fine = TM.refine_block_layout(layout, 2, 2)
    assert fine.shape == (8, 8)
    base = TM.MaskSpec(causal=True).element_mask(s, s) if causal else None
    assert torch.equal(
        TM.layout_to_element_mask(layout, blk, blk, s, s, base_mask=base),
        TM.layout_to_element_mask(fine, 64, 64, s, s, base_mask=base))
    q, k, v = _qkv(4, 1, 2, 2, s, 16)
    to, jo = _both(q, k, v, layout, causal=causal)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    kvm = np.random.default_rng(4).random((1, s)) > 0.3
    to, jo = _both(q, k, v, layout, causal=causal, kv_mask=kvm)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    tg, jg = _grads(q, k, v, layout, causal=causal)
    _close_scaled(tg, jg)


def test_128_blocks_with_a_padded_tail():
    """510 rows under a 4 x 4 pattern: blocks of ceil(510 / 4) = 128 rows,
    the sequence padded to 512 before the refinement; o and the gradients
    against the reference."""
    s = 510
    layout = TM.butterfly_block_layout(s, s, 128, 128, causal=True)
    assert layout.shape == (4, 4)
    q, k, v = _qkv(9, 1, 2, 1, s, 16)
    kvm = np.random.default_rng(9).random((1, s)) > 0.3
    to, jo = _both(q, k, v, layout, causal=True, kv_mask=kvm)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    tg, jg = _grads(q, k, v, layout, causal=True, kv_mask=kvm)
    _close_scaled(tg, jg)


def test_other_blocks_run_on_the_cpu_and_are_refused_for_the_card():
    """A 96-row block is neither at most 64 nor a multiple of it: the CPU
    takes it as the reference does, the card's tile choice refuses it
    (the card test raises at the op)."""
    s = 192
    q, k, v = _qkv(5, 1, 2, 2, s, 16)
    layout = np.array([[1, 0], [1, 1]], np.uint8)
    to, jo = _both(q, k, v, layout, causal=True)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    assert tuning.sparse_tile(96, on_card=False) == (96, 1)
    assert tuning.sparse_tile(48, on_card=True) == (48, 1)
    with pytest.raises(ValueError, match="neither at most 64 nor a multiple"):
        tuning.sparse_tile(96, on_card=True)


# ---------------------------------------------------------------------------
# the attention dispatch and the attention layer
# ---------------------------------------------------------------------------

def test_block_sparse_impl_requires_a_layout_and_equals_pallas():
    s = 128
    q, k, v = map(torch.as_tensor, _qkv(6, 1, 2, 2, s, 16))
    layout = TM.butterfly_block_layout(s, s, 32, 32, causal=True)
    sparse = AttentionSpec(impl="block_sparse", causal=True)
    with pytest.raises(ValueError, match="requires block_layout"):
        attention(q, k, v, sparse)
    got = attention(q, k, v, sparse, block_layout=layout)
    want = attention(q, k, v, dataclasses.replace(sparse, impl="pallas"),
                     block_layout=layout)
    assert torch.equal(got, want)
    dense = attention(q, k, v, dataclasses.replace(sparse, impl="pallas"))
    assert not torch.allclose(got, dense)


def test_apply_attention_threads_the_layout():
    """The attention layer at the reference's signature: its output at a
    butterfly layout against the reference's layer with the same
    weights."""
    cfg = reduced_config("gpt2-small", attn_impl="block_sparse")
    jcfg = jax_reduced_config("gpt2-small", attn_impl="block_sparse")
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = {n: torch.as_tensor(np.array(a)) for n, a in jp.items()}
    x = np.random.default_rng(8).standard_normal((2, 128, cfg.d_model)
                                                 ).astype(np.float32)
    layout = TM.butterfly_block_layout(128, 128, 32, 32, causal=cfg.causal)
    got = tattn.apply_attention(tp, cfg, torch.as_tensor(x),
                                block_layout=layout)
    want = jattn.apply_attention(jp, jcfg, jnp.asarray(x),
                                 block_layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
