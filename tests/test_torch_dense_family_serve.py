"""Serving the reference's other dense decoders on the CPU, against the
JAX package with its weights handed over by ``params_from_jax``: reduced
qwen3-32b (qk-norm, GQA 4:1, head_dim 32 decoupled from d_model 64, so
the pools hold 32-wide rows) and olmo-1b (non-parametric LayerNorm,
untied head).

  * ``prefill_packed``, two ``prefill_chunk_paged`` calls (the second
    reading its history through the page list) and a paged
    ``decode_step``: logits at atol 1e-4, K/V rows and pool pages too, for
    ``attn_impl`` ``chunked`` and ``pallas`` (the kernels' plain
    versions);
  * the ``ServingEngine``'s greedy tokens identical to the JAX engine's
    for qwen3-32b, paged (chunked prefill, a prefix-cache hit) and dense
    (fixed slots, packed prefill), through both impls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine
from repro_torch.serve import kv_cache as kvc

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-4
PAGE, NUM_PAGES, PAGES_PER_SEQ = 4, 16, 8
TABLES = [[3, 9, 1], [12, 5]]                 # physical pages per request
OVERRIDES = {"qwen3-32b": {"head_dim": 32}, "olmo-1b": {}}


def _jax_side(arch):
    jmodel = jax_build_model(jax_reduced_config(arch, **OVERRIDES[arch]))
    params = jmodel.init(jax.random.PRNGKey(0))
    return arch, jmodel, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=sorted(OVERRIDES))
def family(request):
    return _jax_side(request.param)


@pytest.fixture(scope="module")
def qwen3():
    return _jax_side("qwen3-32b")


def _port(arch, np_params, impl):
    cfg = reduced_config(arch, attn_impl=impl,
                         use_decode_kernel=impl == "pallas", **OVERRIDES[arch])
    return build_model(cfg), params_from_jax(np_params, cfg, device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


def _chunk_batch(prompts, starts, lengths, bucket=16, kv_bucket=32):
    """Host inputs of one packed chunk call, built with the port's kv_cache
    helpers (identical numpy code to the JAX package's)."""
    q_off = np.concatenate([[0], np.cumsum(lengths)])
    Sq = int(q_off[-1]) + (-int(q_off[-1])) % bucket
    toks = np.zeros((1, Sq), np.int32)
    qseg = np.full((1, Sq), -1, np.int32)
    qpos = np.full((1, Sq), kvc.masks.POS_PAD, np.int32)
    for i, (st, n) in enumerate(zip(starts, lengths)):
        sl = slice(int(q_off[i]), int(q_off[i + 1]))
        toks[0, sl] = prompts[i][st:st + n]
        qseg[0, sl] = i
        qpos[0, sl] = np.arange(st, st + n)
    tables = TABLES[:len(starts)]
    dest_page, dest_off = kvc.chunk_destinations(
        tables, starts, q_off, lengths, PAGE, Sq, NUM_PAGES)
    spans = [st + n for st, n in zip(starts, lengths)]
    page_list, kseg, kpos = kvc.paged_prefix_lists(tables, spans, PAGE,
                                                   kv_bucket // PAGE)
    return {"tokens": toks, "q_segment_ids": qseg, "q_positions": qpos,
            "kv_segment_ids": kseg[None], "kv_positions": kpos[None],
            "dest_page": dest_page, "dest_off": dest_off,
            "page_list": page_list[None]}, q_off


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_packed_and_chunked_prefill_then_decode_logits(family, impl):
    arch, jmodel, jparams, np_params = family
    model, params = _port(arch, np_params, impl)
    hd = model.cfg.head_dim
    rng = np.random.default_rng(0)

    # packed zero-offset prefill: two documents and a padded tail
    toks = rng.integers(1, 256, size=(1, 24)).astype(np.int32)
    seg = np.full((1, 24), -1, np.int32)
    seg[0, :9], seg[0, 9:20] = 0, 1
    jc, jl = jmodel.prefill_packed(jparams, {"tokens": jnp.asarray(toks),
                                             "segment_ids": jnp.asarray(seg)})
    tc, tl = model.prefill_packed(params, {"tokens": torch.as_tensor(toks),
                                           "segment_ids": torch.as_tensor(seg)})
    assert tc["kv"]["k"].shape[-1] == hd
    _close(tl[0, :20], jl[0, :20])
    _close(tc["kv"]["k"][:, :, :, :20], jc["kv"]["k"][:, :, :, :20])
    _close(tc["kv"]["v"][:, :, :, :20], jc["kv"]["v"][:, :, :, :20])

    # two chunk calls against the page pool, then one paged decode step
    prompts = [rng.integers(1, 256, size=11), rng.integers(1, 256, size=7)]
    jstate = jmodel.init_paged_decode_state(2, NUM_PAGES, PAGE, PAGES_PER_SEQ)
    tstate = model.init_paged_decode_state(2, NUM_PAGES, PAGE, PAGES_PER_SEQ,
                                           device="cpu")
    assert tstate["caches"]["kv"]["k"].shape[-1] == hd
    jcaches, tcaches = jstate["caches"], tstate["caches"]
    for starts, lengths in (([0, 0], [6, 7]), ([6], [5])):
        batch, q_off = _chunk_batch(prompts, starts, lengths)
        jcaches, jl = jmodel.prefill_chunk_paged(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcaches)
        tcaches, tl = model.prefill_chunk_paged(
            params, {k: torch.as_tensor(v) for k, v in batch.items()}, tcaches)
        _close(tl[0, :int(q_off[-1])], jl[0, :int(q_off[-1])])
    used = sorted(p for t in TABLES for p in t)
    _close(tcaches["kv"]["k"][:, :, used], jcaches["kv"]["k"][:, :, used])

    table = np.full((2, PAGES_PER_SEQ), -1, np.int32)
    for i, t in enumerate(TABLES):
        table[i, :len(t)] = t
    kv_len = np.array([11, 7], np.int32)
    token = np.array([17, 42], np.int32)
    jnew, jlog = jmodel.decode_step(
        jparams, {"caches": jcaches, "page_table": jnp.asarray(table),
                  "kv_len": jnp.asarray(kv_len)}, jnp.asarray(token))
    tnew, tlog = model.decode_step(
        params, {"caches": tcaches, "page_table": torch.as_tensor(table),
                 "kv_len": torch.as_tensor(kv_len)}, torch.as_tensor(token))
    _close(tlog, jlog)
    _close(tnew["caches"]["kv"]["v"][:, :, used],
           jnew["caches"]["kv"]["v"][:, :, used])


SHARED = list(range(1, 21))
PROMPTS = [SHARED + [40, 41, 42], [5, 9, 2], list(range(60, 79)),
           SHARED + [50, 51], [7, 7, 1, 4]]
MODES = {
    "paged": dict(paged=True, num_slots=3, capacity=64, page_size=8,
                  chunk_size=8),
    "dense": dict(paged=False, num_slots=3, capacity=64),
}


def _serve(engine, prompts, n_new):
    engine.submit(prompts[0], max_new_tokens=n_new)
    engine.run()                       # primes the prefix cache (paged)
    for p in prompts[1:]:
        engine.submit(p, max_new_tokens=n_new)
    engine.run()
    return {r.rid: r.output for r in engine.finished}


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_qwen3_greedy_tokens_identical_to_jax_engine(qwen3, mode, impl):
    arch, jmodel, jparams, np_params = qwen3
    kw = MODES[mode]
    ref = _serve(JaxEngine(jmodel, jparams, **kw), PROMPTS, 6)
    model, params = _port(arch, np_params, impl)
    eng = ServingEngine(model, params, device="cpu", **kw)
    assert _serve(eng, PROMPTS, 6) == ref
    if mode == "paged":
        assert eng.prefix_hits >= 1


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "internlm2-20b",
                                  "gpt2-small", "gpt2-medium", "bert-large"])
def test_serve_launcher_takes_every_arch(arch):
    """``launch.serve`` builds each registered arch through ``get_config``
    (here reduced, on the CPU) and serves every request."""
    from repro_torch.launch import serve as launch_serve

    eng = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "2", "--max-new", "4"])
    assert eng.model.cfg.name == arch
    assert len(eng.finished) == 2 and all(r.output for r in eng.finished)
