"""Training-path attention parity on the CPU: the port's counter-based
dropout mask, its differentiable ``ops.flash_attention`` (forward with
dropout / ``variant="paper"`` / packed segments, and the gradients through
the plain backward) and ``ref.standard_attention`` against the JAX
package, on the same numpy inputs made from a seed. The JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_kernels_flash.py`` does.

Tolerances: the dropout keep mask is bit-equal; forward outputs atol 1e-5
(fp32, summation order); gradients are scaled by their max |.| and
compared at rtol 1e-4, atol 1e-5 (the tolerance of
``tests/test_kernels_flash.py``). Also: the kernel build's digest covers
the shared headers, and the backward tiles fit shared memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref, tuning

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-5


# ---------------------------------------------------------------------------
# dropout keep mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 77, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("p_drop", [0.1, 0.5])
def test_dropout_keep_mask_bit_equal(seed, p_drop):
    want = np.asarray(jref.full_dropout_keep_mask(seed, 2, 3, 33, 47, p_drop))
    got = ref.full_dropout_keep_mask(seed, 2, 3, 33, 47, p_drop).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - p_drop)) < 0.05


def test_dropout_keep_mask_bit_equal_across_uint32_wrap():
    """Coordinates whose flat index passes 2**32 (5 heads, 70k x 70k), where
    the int64-masked arithmetic has to wrap exactly as uint32 does."""
    rng = np.random.default_rng(0)
    n = 256
    b = rng.integers(0, 4, n)
    h = rng.integers(0, 5, n)
    q = rng.integers(0, 70_000, n)
    k = rng.integers(0, 70_000, n)
    assert (((b * 5 + h) * 70_000 + q) * 70_000 + k).max() > 2**32
    want = np.asarray(jref.dropout_keep_mask(
        9, *map(jnp.asarray, (b, h, q, k)), 0.3, 5, 70_000, 70_000))
    got = ref.dropout_keep_mask(9, *map(torch.as_tensor, (b, h, q, k)), 0.3,
                                5, 70_000, 70_000).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_threshold_is_the_jax_one():
    for p in (0.0, 0.1, 0.2, 0.5, 0.999):
        assert ref.dropout_threshold(p) == int(p * float(2**32 - 1))


# ---------------------------------------------------------------------------
# the differentiable op against the JAX op (Pallas, interpret mode)
# ---------------------------------------------------------------------------

def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, hq, sq, d), f(b, hkv, sk, d), f(b, hkv, sk, d), f(b, hq, sq, d)


def _segments(seed, b, s):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
        seg[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return seg


def _scaled_close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=1e-4, atol=1e-5)


CASES = {
    # name: (b, hq, hkv, sq, sk, d, kwargs)
    "causal": (2, 4, 2, 64, 64, 16, dict(causal=True)),
    "noncausal_gqa4_1": (1, 4, 1, 40, 72, 16, dict(causal=False)),
    "window48": (1, 4, 2, 96, 96, 16, dict(causal=True, window=48)),
    "kv_padding": (2, 4, 2, 48, 70, 16, dict(causal=False)),
    "segments": (2, 4, 2, 64, 64, 16, dict(causal=True, segments=True)),
    "dropout": (2, 4, 2, 56, 56, 16, dict(causal=True, dropout_p=0.1,
                                          dropout_seed=11)),
}


def _run_both(name, want_grads=True):
    b, hq, hkv, sq, sk, d, kw = CASES[name]
    q, k, v, do = _inputs(len(name), b, hq, hkv, sq, sk, d)
    kw = dict(kw)
    if kw.pop("segments", False):
        kw["segment_ids"] = _segments(3, b, sq)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    tkw = {n: torch.as_tensor(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    blocks = dict(block_q=32, block_k=32)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, **blocks, **jkw) * do)

    jo = jops.flash_attention(*map(jnp.asarray, (q, k, v)), **blocks, **jkw)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to = ops.flash_attention(*leaves, **blocks, **tkw)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)
    if want_grads:
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tg = torch.autograd.grad(to, leaves, torch.as_tensor(do))
        for g, w in zip(tg, jg):
            assert g.shape == w.shape
            _scaled_close(g.numpy(), w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_grads_match_jax(name):
    _run_both(name)


@pytest.mark.parametrize("kw", [
    dict(causal=True, dropout_p=0.2, dropout_seed=5),
    dict(causal=True, variant="paper"),
    dict(causal=True, segments=True),
], ids=["dropout", "paper", "segments"])
def test_flash_attention_forward_matches_jax(kw):
    q, k, v, _ = _inputs(7, 2, 4, 2, 72, 72, 16)
    kw = dict(kw)
    if kw.pop("segments", False):
        kw["segment_ids"] = _segments(5, 2, 72)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    tkw = {n: torch.as_tensor(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    jo = jops.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=32,
                              block_k=32, **jkw)
    to = ops.flash_attention(*map(torch.as_tensor, (q, k, v)), **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dropout_p", [0.0, 0.25])
def test_standard_attention_grads_match_jax(dropout_p):
    """The port's Algorithm-0 oracle (``ref.standard_attention``) and its
    autograd gradients against JAX's oracle under ``jax.grad``."""
    q, k, v, do = _inputs(2, 2, 4, 2, 40, 40, 16)
    seg = _segments(1, 2, 40)
    kw = dict(causal=True, dropout_p=dropout_p, dropout_seed=3)

    def jloss(q_, k_, v_):
        return jnp.sum(jref.standard_attention(
            q_, k_, v_, segment_ids=jnp.asarray(seg), **kw) * do)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    to = ref.standard_attention(*leaves, segment_ids=torch.as_tensor(seg), **kw)
    jo = jref.standard_attention(*map(jnp.asarray, (q, k, v)),
                                 segment_ids=jnp.asarray(seg), **kw)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)
    tg = torch.autograd.grad(to, leaves, torch.as_tensor(do))
    for g, w in zip(tg, jg):
        _scaled_close(g.numpy(), w)


def test_chunked_impl_refuses_dropout():
    from repro_torch.core.attention import AttentionSpec, attention
    x = torch.randn(1, 2, 8, 16)
    spec = AttentionSpec(impl="chunked", dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout"):
        attention(x, x, x, spec, deterministic=False)
    attention(x, x, x, spec, deterministic=True)    # dropout off: runs


# ---------------------------------------------------------------------------
# build and tiles
# ---------------------------------------------------------------------------

def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a ``csrc/*.cuh`` header changes the library name of every
    kernel, so a stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._target("k")
    assert build._target("k") == before                 # deterministic
    (tmp_path / "common.cuh").write_text("// v2\n")
    after = build._target("k")
    assert after != before and after.name.startswith("k-")
    (tmp_path / "extra.cuh").write_text("// new header\n")
    assert build._target("k") != after
    assert "flash_bwd" in build.SOURCES


def test_bwd_tiles_fit_shared_memory():
    for d in tuning.KERNEL_HEAD_DIMS:
        bq, bk = tuning.bwd_tiles(d)
        assert (bq, bk) == tuning.fwd_tiles(d)
        assert tuning.bwd_smem_bytes(bq, bk, d) <= tuning.SMEM_PER_BLOCK
    assert tuning.bwd_smem_bytes(64, 64, 128) == 166_144
