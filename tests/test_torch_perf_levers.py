"""The chunked path's levers of the port (``attn_chunk_size``,
``attn_pv_bf16``, ``banded_window``) on the CPU, against the JAX package
(the counterpart of ``tests/test_perf_levers.py``'s ``TestBandedWindow``
and chunked fast paths):

  * ``window_banded_attention`` against the reference's at (s, w) = (256,
    64), (257, 64), (512, 128) and (64, 128), GQA 4:2: output and the
    three gradients (of a random cotangent) within atol 1e-5, gradients
    once scaled by their max;
  * ``chunked_attention`` at several ``chunk_size`` values, causal with
    and without a window and non-causal, with ``pv_bf16`` off and on,
    against the reference's ``chunked_attention`` at the same settings
    (outputs atol 1e-5; with ``pv_bf16`` atol 2e-3, a P entry at a bf16
    rounding boundary going either way, and 2e-2 of the float32 path, the
    reference test's bf16 bound);
  * the dispatch: ``banded_window`` takes the banded path only for a
    windowed self-attention with no kv_mask, segment ids or positions and
    q_offset 0, as the reference's rule;
  * reduced hymba-1.5b (window 64) with and without ``banded_window``:
    logits within 1e-4 of each other and of the JAX model's; and
    ``attn_chunk_size`` / ``attn_pv_bf16`` reaching the attention through
    the config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build_model
from repro_torch.configs import reduced_config
from repro_torch.core.attention import AttentionSpec, attention
from repro_torch.kernels import ref
from repro_torch.models import build_model, params_from_jax

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _scaled(got, want, atol):
    s = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               atol=atol, rtol=0)


def _port_and_grads(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_and_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("s, w", [(256, 64), (257, 64), (512, 128),
                                  (64, 128)])
def test_window_banded_matches_jax(s, w):
    arrays = _qkv(s, 2, 4, 2, s, 32)
    cot = np.random.default_rng(s + 1).standard_normal(
        arrays[0].shape).astype(np.float32)
    got, ggot = _port_and_grads(
        lambda q, k, v: ref.window_banded_attention(q, k, v, window=w),
        arrays, cot)
    want, gwant = _jax_and_grads(
        lambda q, k, v: jax_ref.window_banded_attention(q, k, v, window=w),
        arrays, cot)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for g, gw in zip(ggot, gwant):
        _scaled(g, gw, 1e-5)
    # and it is the windowed causal attention itself
    full = ref.standard_attention(*map(torch.tensor, arrays), causal=True,
                                  window=w)
    np.testing.assert_allclose(got, full.numpy(), atol=1e-5, rtol=0)


MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=48),
         "full": dict(causal=False)}


@pytest.mark.parametrize("chunk", [64, 100, 256])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("pv_bf16", [False, True])
def test_chunked_matches_jax(chunk, mask, pv_bf16):
    arrays = _qkv(chunk, 1, 4, 2, 200, 32)
    kw = dict(MASKS[mask], chunk_size=chunk, pv_bf16=pv_bf16)
    got = ref.chunked_attention(*map(torch.tensor, arrays), **kw).numpy()
    want = np.asarray(jax_ref.chunked_attention(*map(jnp.asarray, arrays),
                                                **kw))
    np.testing.assert_allclose(got, want, atol=2e-3 if pv_bf16 else 1e-5,
                               rtol=0)
    if pv_bf16:
        exact = ref.chunked_attention(*map(torch.tensor, arrays),
                                      **dict(kw, pv_bf16=False)).numpy()
        np.testing.assert_allclose(got, exact, atol=2e-2, rtol=2e-2)
        assert np.abs(got - exact).max() > 0      # the P tile is bf16


def test_chunked_pv_bf16_grads_match_jax():
    arrays = _qkv(7, 1, 2, 2, 160, 32)
    cot = np.random.default_rng(8).standard_normal(
        arrays[0].shape).astype(np.float32)
    kw = dict(causal=True, chunk_size=64, pv_bf16=True)
    _, ggot = _port_and_grads(
        lambda q, k, v: ref.chunked_attention(q, k, v, **kw), arrays, cot)
    _, gwant = _jax_and_grads(
        lambda q, k, v: jax_ref.chunked_attention(q, k, v, **kw), arrays, cot)
    for g, gw in zip(ggot, gwant):
        _scaled(g, gw, 2e-2)


def _dispatched(monkeypatch, **kw):
    """Which path ``attention`` takes for a windowed chunked spec with
    ``banded_window``: "banded" or "chunked"."""
    taken = []
    for name in ("window_banded_attention", "chunked_attention"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _f=fn, _n=name, **k: (
            taken.append(_n), _f(*a, **k))[1])
    q, k, v = map(torch.tensor, _qkv(3, 1, 2, 1, 96, 16))
    spec = AttentionSpec(impl="chunked", window=32, banded_window=True)
    if kw.pop("short_q", False):
        q = q[:, :, :64]
    attention(q, k, v, spec, **kw)
    return {"window_banded_attention": "banded",
            "chunked_attention": "chunked"}[taken[0]]


def test_banded_dispatch_rule(monkeypatch):
    ids = torch.zeros((1, 96), dtype=torch.int32)
    pos = torch.arange(96)[None]
    assert _dispatched(monkeypatch) == "banded"
    assert _dispatched(monkeypatch, q_offset=0) == "banded"
    assert _dispatched(monkeypatch,
                       kv_mask=torch.ones((1, 96), dtype=torch.bool)
                       ) == "chunked"
    assert _dispatched(monkeypatch, segment_ids=ids) == "chunked"
    assert _dispatched(monkeypatch, q_segment_ids=ids,
                       kv_segment_ids=ids) == "chunked"
    assert _dispatched(monkeypatch, q_positions=pos,
                       kv_positions=pos) == "chunked"
    assert _dispatched(monkeypatch, short_q=True) == "chunked"


@pytest.fixture(scope="module")
def hymba():
    """Reduced hymba-1.5b's JAX params and logits at banded_window on and
    off, on 2 x 150 tokens without segment ids (window 64: three bands)."""
    tokens = np.random.default_rng(4).integers(0, 256, (2, 150)).astype(
        np.int32)
    jcfg = jax_reduced_config("hymba-1.5b")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    want = {}
    for banded in (False, True):
        jmodel = jax_build_model(dataclasses.replace(jcfg,
                                                     banded_window=banded))
        logits, _ = jax.jit(jmodel.forward)(jparams,
                                            {"tokens": jnp.asarray(tokens)})
        want[banded] = np.asarray(logits)
    return jax.tree.map(np.asarray, jparams), tokens, want


@pytest.mark.parametrize("banded", [False, True])
def test_hymba_banded_window_matches_jax(hymba, banded, monkeypatch):
    np_params, tokens, want = hymba
    cfg = dataclasses.replace(reduced_config("hymba-1.5b"),
                              banded_window=banded)
    assert cfg.window == 64
    calls = []
    fn = ref.window_banded_attention
    monkeypatch.setattr(ref, "window_banded_attention",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    params = params_from_jax(np_params, cfg, device="cpu")
    with torch.no_grad():
        logits, _ = build_model(cfg).forward(params, {"tokens": tokens})
    assert len(calls) == (cfg.num_layers if banded else 0)
    np.testing.assert_allclose(logits.numpy(), want[banded], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(logits.numpy(), want[not banded], atol=1e-4,
                               rtol=0)


def test_chunk_size_and_pv_bf16_reach_the_attention(monkeypatch):
    cfg = dataclasses.replace(reduced_config("olmo-1b"), attn_chunk_size=32,
                              attn_pv_bf16=True)
    seen = []
    fn = ref.chunked_attention
    monkeypatch.setattr(ref, "chunked_attention", lambda *a, **k: (
        seen.append((k["chunk_size"], k["pv_bf16"])), fn(*a, **k))[1])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (1, 40))
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": tokens})
    assert seen == [(32, True)] * cfg.num_layers
    assert bool(torch.isfinite(logits).all())
