"""Model parity on the CPU: with the JAX package's weights handed over by
``params_from_jax``, the port's ``prefill_packed``, ``prefill_chunk_paged``
and ``decode_step`` give the JAX model's logits (and pool contents) on
``reduced_config("granite-3-2b")``, at atol 1e-4 in fp32. The port runs
both its ``chunked`` attention (the default, as in the JAX package) and
``pallas`` — the kernels' plain versions on CPU tensors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import reduced_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import kv_cache as kvc

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ATOL = 1e-4
PAGE, NUM_PAGES, PAGES_PER_SEQ = 4, 16, 8
TABLES = [[3, 9, 1], [12, 5]]                 # physical pages per request


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config("granite-3-2b")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(np_params, impl):
    cfg = reduced_config("granite-3-2b", attn_impl=impl,
                         use_decode_kernel=impl == "pallas")
    return build_model(cfg), params_from_jax(np_params, cfg, device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


def test_params_from_jax_unstacks_layers(jax_side):
    _, _, np_params = jax_side
    model, params = _port(np_params, "chunked")
    assert len(params["blocks"]) == model.cfg.num_layers
    for l in range(model.cfg.num_layers):
        np.testing.assert_array_equal(
            params["blocks"][l]["attn"]["wq"].numpy(),
            np_params["blocks"]["attn"]["wq"][l])
    np.testing.assert_array_equal(params["embed"].numpy(), np_params["embed"])


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_packed_logits_and_kv(jax_side, impl):
    jmodel, jparams, np_params = jax_side
    model, params = _port(np_params, impl)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 256, size=(1, 24)).astype(np.int32)
    seg = np.full((1, 24), -1, np.int32)
    seg[0, :9], seg[0, 9:20] = 0, 1            # two documents + a padded tail
    jc, jl = jmodel.prefill_packed(jparams, {"tokens": jnp.asarray(toks),
                                             "segment_ids": jnp.asarray(seg)})
    tc, tl = model.prefill_packed(params, {"tokens": torch.as_tensor(toks),
                                           "segment_ids": torch.as_tensor(seg)})
    _close(tl[0, :20], jl[0, :20])
    _close(tc["kv"]["k"][:, :, :, :20], jc["kv"]["k"][:, :, :, :20])
    _close(tc["kv"]["v"][:, :, :, :20], jc["kv"]["v"][:, :, :, :20])


def _chunk_batch(rng_tokens, starts, lengths, bucket=16, kv_bucket=32):
    """Host inputs of one packed chunk call, built with the port's kv_cache
    helpers (identical numpy code to the JAX package's)."""
    q_off = np.concatenate([[0], np.cumsum(lengths)])
    Sq = int(q_off[-1]) + (-int(q_off[-1])) % bucket
    toks = np.zeros((1, Sq), np.int32)
    qseg = np.full((1, Sq), -1, np.int32)
    qpos = np.full((1, Sq), kvc.masks.POS_PAD, np.int32)
    for i, (st, n) in enumerate(zip(starts, lengths)):
        sl = slice(int(q_off[i]), int(q_off[i + 1]))
        toks[0, sl] = rng_tokens[i][st:st + n]
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
def test_chunked_prefill_then_decode_logits(jax_side, impl):
    """Two chunk calls (the second with history read through the page
    list), then one paged decode step: logits and pool contents agree."""
    jmodel, jparams, np_params = jax_side
    model, params = _port(np_params, impl)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=11), rng.integers(1, 256, size=7)]
    jstate = jmodel.init_paged_decode_state(2, NUM_PAGES, PAGE, PAGES_PER_SEQ)
    tstate = model.init_paged_decode_state(2, NUM_PAGES, PAGE, PAGES_PER_SEQ,
                                           device="cpu")
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
    jstate = {"caches": jcaches, "page_table": jnp.asarray(table),
              "kv_len": jnp.asarray(kv_len)}
    tstate = {"caches": tcaches, "page_table": torch.as_tensor(table),
              "kv_len": torch.as_tensor(kv_len)}
    jnew, jlog = jmodel.decode_step(jparams, jstate, jnp.asarray(token))
    tnew, tlog = model.decode_step(params, tstate, torch.as_tensor(token))
    _close(tlog, jlog)
    _close(tnew["caches"]["kv"]["v"][:, :, used],
           jnew["caches"]["kv"]["v"][:, :, used])
    assert tnew["kv_len"].tolist() == [12, 8]


def test_decode_kernel_flag_reaches_same_logits(jax_side):
    """use_decode_kernel=True (the split-KV kernel's plain version on CPU)
    and the plain masked-softmax path give the same decode logits."""
    _, _, np_params = jax_side
    outs = []
    for flag in (False, True):
        cfg = reduced_config("granite-3-2b", use_decode_kernel=flag,
                             num_decode_splits=2 if flag else None)
        model = build_model(cfg)
        params = params_from_jax(np_params, cfg, device="cpu")
        state = model.init_paged_decode_state(2, NUM_PAGES, PAGE,
                                              PAGES_PER_SEQ, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for leaf in state["caches"]["kv"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        state["page_table"][0, :3] = torch.tensor([3, 9, 1])
        state["page_table"][1, :2] = torch.tensor([12, 5])
        state["kv_len"] = torch.tensor([10, 6], dtype=torch.int32)
        _, logits = model.decode_step(params, state, torch.tensor([5, 6]))
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], atol=ATOL, rtol=0)


def test_init_draws_reduced_shapes_on_cpu():
    cfg = dataclasses.replace(reduced_config("granite-3-2b"), num_layers=1)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)
    wq = params["blocks"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    # truncated normal: |w| <= 2 stddev, stddev = 1/sqrt(fan_in)
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
