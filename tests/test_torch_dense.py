"""Dense-slot serving on the CPU against the JAX package: the contiguous
split-KV decode (``flash_decode``, whose plain version the CUDA kernel
computes) against the JAX Pallas kernel in interpret mode, the decode
geometry resolution and its validation errors, ``Model.prefill`` /
``decode_step`` over the slot cache, and the dense ``ServingEngine``'s
greedy tokens against the JAX ``ServingEngine(paged=False)`` (single and
packed admission, with and without the decode kernel) and against the
port's own paged engine. Also the packed-prefill layout-skip counters
against the JAX engine's, in dense and paged mode. Inputs come from numpy
seeds; tolerances: decode outputs and partials atol 1e-5, logits 1e-4,
tokens and counters identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import flash_decode as jfd
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.core import masks as TM
from repro_torch.core.attention import AttentionSpec, decode_attention
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import tuning
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0)


def _decode_case(seed, *, b=4, hq=4, hkv=2, d=16, cap=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kv_len = np.array([13, cap, 0, 40], np.int32)[:b]   # a kv_len 0 row
    kv_mask = rng.random((b, cap)) > 0.3
    kv_mask[3, 30:40] = False                     # a masked-out block
    return f(b, hq, 1, d), f(b, hkv, cap, d), f(b, hkv, cap, d), kv_len, kv_mask


@pytest.mark.parametrize("block_k,num_splits,window,use_mask", [
    (8, 2, None, False), (16, 4, 10, True), (64, 1, None, True),
    (32, 2, 5, False), (8, 8, 20, True)])
def test_flash_decode_matches_pallas(monkeypatch, block_k, num_splits, window,
                                     use_mask):
    """Partials and merged output against the JAX kernel (interpret mode):
    GQA 4/2, a window, a kv_mask, a kv_len 0 row (zeros out)."""
    q, k, v, kv_len, kvm = _decode_case(block_k + num_splits)
    kvm = kvm if use_mask else None
    before = dict(tfd.LAUNCHES)
    captured = {}
    merge = jfd._merge_split_partials

    def capture(o_p, m_p, l_p, dtype):
        captured.update(o_p=o_p, m_p=m_p, l_p=l_p)
        return merge(o_p, m_p, l_p, dtype)

    monkeypatch.setattr(jfd, "_merge_split_partials", capture)
    jo = jfd.flash_decode(*map(jnp.asarray, (q, k, v, kv_len)),
                          block_k=block_k, num_splits=num_splits,
                          window=window,
                          kv_mask=None if kvm is None else jnp.asarray(kvm),
                          interpret=True)
    tq, tk, tv, tkl = map(torch.as_tensor, (q, k, v, kv_len))
    tkvm = None if kvm is None else torch.as_tensor(kvm)
    valid = TM.decode_kv_valid(tkl, k.shape[2], window=window, kv_mask=tkvm)
    lay = TM.kv_block_layout(valid, block_k)
    parts = tfd.flash_decode_partials(
        tq, tk, tv, tkl, lay, scale=1.0 / np.sqrt(q.shape[-1]),
        block_k=block_k, num_splits=num_splits, window=window, kv_mask=tkvm)
    for got, name in zip(parts, ("o_p", "m_p", "l_p")):
        _close(got, captured[name])
    to = tfd.flash_decode(tq, tk, tv, tkl, block_k=block_k,
                          num_splits=num_splits, window=window, kv_mask=tkvm)
    _close(to, jo)
    assert torch.all(to[2] == 0)                 # kv_len 0: zeros
    # the dispatch routes use_decode_kernel to the same function
    spec = AttentionSpec(window=window, block_k=block_k,
                         num_decode_splits=num_splits, use_decode_kernel=True)
    _close(decode_attention(tq, tk, tv, tkl, spec, kv_mask=tkvm), jo)
    assert tfd.LAUNCHES == before                # CPU tensors: no launch


def test_flash_decode_takes_any_split_count_on_cpu():
    """On the CPU the contiguous decode takes more splits than the card's
    cluster of 8 (16 here, explicit), as the JAX package does, and
    ``flash_decode_from_layout`` returns that decode with its partials."""
    q, k, v, kv_len, kvm = _decode_case(16, cap=128)
    jo = jfd.flash_decode(*map(jnp.asarray, (q, k, v, kv_len)), block_k=8,
                          num_splits=16, kv_mask=jnp.asarray(kvm),
                          interpret=True)
    tq, tk, tv, tkl, tkvm = map(torch.as_tensor, (q, k, v, kv_len, kvm))
    to = tfd.flash_decode(tq, tk, tv, tkl, block_k=8, num_splits=16,
                          kv_mask=tkvm)
    _close(to, jo)
    lay = TM.kv_block_layout(TM.decode_kv_valid(tkl, 128, kv_mask=tkvm), 8)
    whole, parts = tfd.flash_decode_from_layout(
        tq, tk, tv, tkl, lay, scale=q.shape[-1] ** -0.5, block_k=8,
        num_splits=16, window=None, kv_mask=tkvm)
    assert torch.equal(whole, to) and parts[0].shape[2] == 16


def test_decode_geometry_resolution_and_validation():
    """Auto geometry is divisor-valid and within the kernel's tile; the
    explicit values are validated as in the JAX package."""
    from repro.kernels import tuning as jtuning
    for cap in (64, 96, 1056, 2048):
        bk, ns = tuning.resolve_decode_geometry(cap, None, None)
        assert cap % bk == 0 and (cap // bk) % ns == 0
        assert bk <= tuning.DECODE_TILE and ns <= tuning.TARGET_DECODE_SPLITS
    assert tuning.resolve_decode_geometry(2048, None, None) == (64, 8)
    assert tuning.resolve_decode_geometry(1056, None, None) == (16, 6)
    assert tuning.resolve_decode_geometry(96, None, 3) == \
        jtuning.resolve_decode_geometry(96, None, 3, head_dim=16)
    assert tuning.resolve_decode_geometry(96, 32, None) == (32, 3)
    assert tuning.resolve_decode_geometry(100, None, None) == (100, 1)
    for args in ((100, 16, 2), (96, 32, 2)):
        with pytest.raises(ValueError, match="multiple of"):
            tfd.validate_decode_geometry(*args)
        with pytest.raises(ValueError, match="multiple of"):
            jfd.validate_decode_geometry(*args)
    assert tfd.validate_decode_geometry(64, 128, 4) == \
        jfd.validate_decode_geometry(64, 128, 4)
    with pytest.raises(ValueError, match="num_splits"):
        tuning.resolve_decode_geometry(64, None, 3)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced_config("granite-3-2b")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(np_params, impl="chunked", decode_kernel=None, **kw):
    cfg = reduced_config("granite-3-2b", attn_impl=impl,
                         use_decode_kernel=(impl == "pallas"
                                            if decode_kernel is None
                                            else decode_kernel), **kw)
    return build_model(cfg), params_from_jax(np_params, cfg, device="cpu")


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_model_prefill_and_decode_logits_match_jax(weights, impl):
    """Model.prefill into a slot cache, then decode steps with the split-KV
    kernel (pallas: the JAX side in interpret mode): logits within 1e-4."""
    _, jparams, np_params = weights
    jcfg = jax_reduced_config("granite-3-2b", attn_impl=impl,
                              use_decode_kernel=impl == "pallas")
    jmodel = jax_build_model(jcfg)
    model, params = _port(np_params, impl)
    tokens = np.array([[5, 9, 2, 7, 1, 3], [8, 8, 4, 2, 6, 11]], np.int32)
    cap = 16
    jstate, jl = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, cap)
    state, tl = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, cap)
    _close(tl, jl, 1e-4)
    assert int(state["kv_len"][0]) == tokens.shape[1]
    tok = np.array([3, 4], np.int32)
    for _ in range(3):
        jstate, jl = jmodel.decode_step(jparams, jstate, jnp.asarray(tok))
        state, tl = model.decode_step(params, state, torch.as_tensor(tok))
        _close(tl, jl, 1e-4)
        _close(state["caches"]["kv"]["k"], jstate["caches"]["kv"]["k"], 1e-4)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)
    assert model.decode_capacity(6, 10) == jmodel.decode_capacity(6, 10)


def _serve(engine, prompts, n_new):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    engine.run()
    return {r.rid: r.output for r in engine.finished}


PROMPTS = [[5, 9, 2], [7, 7, 1, 4], [3], [11, 2], [8, 6, 5, 1, 9]]


@pytest.mark.parametrize("packed", [False, True],
                         ids=["single", "packed"])
@pytest.mark.parametrize("decode_kernel", [False, True])
def test_dense_engine_tokens_identical_to_jax(weights, packed,
                                              decode_kernel):
    """Single-request admission (``packed_prefill=False``: one batch-1
    prefill per drained request) and packed admission, decode through the
    plain softmax or the split-KV kernel — the JAX side runs its Pallas
    kernels in interpret mode when they are on."""
    _, jparams, np_params = weights
    impl = "pallas" if decode_kernel else "chunked"
    jcfg = jax_reduced_config("granite-3-2b", attn_impl=impl,
                              use_decode_kernel=decode_kernel)
    kw = dict(num_slots=3, capacity=64, packed_prefill=packed)
    jeng = JaxEngine(jax_build_model(jcfg), jparams, paged=False, **kw)
    ref = _serve(jeng, PROMPTS, 6)
    model, params = _port(np_params, impl, decode_kernel)
    eng = ServingEngine(model, params, paged=False, device="cpu", **kw)
    assert _serve(eng, PROMPTS, 6) == ref
    assert not eng.paged and eng.prefill_calls == jeng.prefill_calls
    if decode_kernel:
        assert (eng.decode_block_k, eng.num_decode_splits) == (8, 8)


def test_dense_engine_matches_port_paged_engine(weights):
    """The two cache layouts serve the same greedy tokens (kernels' plain
    versions), including a prompt that fills most of a slot."""
    _, _, np_params = weights
    model, params = _port(np_params, "pallas")
    prompts = PROMPTS + [list(range(1, 50))]
    kw = dict(num_slots=3, capacity=64)
    dense = _serve(ServingEngine(model, params, paged=False, device="cpu",
                                 **kw), prompts, 8)
    paged = _serve(ServingEngine(model, params, paged=True, device="cpu",
                                 **kw), prompts, 8)
    assert dense == paged


@pytest.mark.parametrize("paged", [False, True])
def test_layout_skip_counters_equal_jax_engine(weights, paged):
    """blocks_skipped / blocks_total / last_prefill_layout_density of the
    packed zero-offset prefills equal the JAX engine's on the same
    requests (dense packed admission; paged zero-offset chunks), at a
    32-row prefill bucket (the report tile)."""
    jmodel, jparams, np_params = weights
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 200, n).tolist() for n in (70, 60, 80, 20)]
    kw = dict(num_slots=4, capacity=128, prefill_bucket=32)
    jeng = JaxEngine(jmodel, jparams, paged=paged, **kw)
    ref = _serve(jeng, prompts, 2)
    model, params = _port(np_params)
    eng = ServingEngine(model, params, paged=paged, device="cpu", **kw)
    assert _serve(eng, prompts, 2) == ref
    assert eng.blocks_total == jeng.blocks_total > 0
    assert eng.blocks_skipped == jeng.blocks_skipped > 0
    assert eng.last_prefill_layout_density == pytest.approx(
        jeng.last_prefill_layout_density, abs=1e-12)
    assert eng.tm.registry.get("serve_blocks_skipped").total() == \
        eng.blocks_skipped


def test_dense_mode_construction_errors(weights):
    """The JAX engine's dense-mode refusals: chunked prefill, prefix cache
    and a token budget need the paged cache; a pinned split count that does
    not divide the cache's blocks fails at construction."""
    _, _, np_params = weights
    model, params = _port(np_params)
    for kw, msg in ((dict(chunk_size=8), "chunk"),
                    (dict(prefix_cache=True), "prefix"),
                    (dict(token_budget=16), "token_budget")):
        with pytest.raises(ValueError, match=msg):
            ServingEngine(model, params, num_slots=2, capacity=32,
                          paged=False, device="cpu", **kw)
    model, params = _port(np_params, "pallas", num_decode_splits=3)
    with pytest.raises(ValueError, match="num_splits"):
        ServingEngine(model, params, num_slots=2, capacity=64, paged=False,
                      device="cpu")
