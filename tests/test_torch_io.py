"""The port's IO model, IO ledger and trace validator against the JAX
package, on the CPU:

  * every device-independent count of ``repro_torch.core.io_model`` is
    bit-equal to ``repro.core.io_model``'s over a grid of shapes (the
    paper's A100 constants too); the H100 constants are the data sheet's,
    and the shared-memory arithmetic of the Hopper kernels lives there
    and nowhere else (``kernels.tuning`` imports it);
  * ``ServePriceModel`` (prefill and decode prices, tp and sp included)
    and ``IOLedger`` (summary, totals, table) equal the reference's on the
    same arguments;
  * the port's paged engine and the JAX engine, serving the same requests
    (atomic, chunked, a prefix hit, preemption), account the same steps
    and tokens per step kind, and the port prices each step with its own
    model (the forward kernel's 64 x 64 tiles, q-major): every step span's
    ``hbm_bytes`` is the reference price model's at those tiles for the
    span's chunks or decode rows, and the ledger's totals are their sums;
    prefix hits are credited (``prefill_hbm_bytes_saved``) and chunk steps
    count the gathers they avoid, as the JAX engine counts them;
  * the port's chrome trace passes the port's validator and the
    reference's, and both validators report the same problems on broken
    traces.
"""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core import io_model as ref_io
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro.telemetry import IOLedger as RefLedger
from repro.telemetry import ServePriceModel as RefPrice
from repro.telemetry.validate import validate_chrome_trace as ref_validate
from repro_torch.configs import reduced_config
from repro_torch.core import io_model
from repro_torch.kernels import tuning
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine
from repro_torch.telemetry import IOLedger, ServePriceModel, chrome_trace_doc
from repro_torch.telemetry import validate
from repro_torch.telemetry.validate import validate_chrome_trace

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py

NS = [64, 96, 1000, 2048]
DS = [16, 64, 96, 128]
BLOCKS = [(64, 64), (128, 32), (96, 200)]


def _eq(a, b):
    """Bit-equal: the same type of result and the same value."""
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _eq(a[k], b[k])
        return
    assert type(a) is type(b) and a == b, (a, b)


def test_constants():
    assert (io_model.A100_SRAM_BYTES, io_model.A100_HBM_BW) == \
        (ref_io.A100_SRAM_BYTES, ref_io.A100_HBM_BW)
    assert io_model.SP_COLLECTIVE_LAUNCH_BYTES == \
        ref_io.SP_COLLECTIVE_LAUNCH_BYTES
    assert (io_model.H100_HBM_BW, io_model.H100_BF16_FLOPS,
            io_model.H100_SMEM_PER_BLOCK) == (3.35e12, 989e12, 232_448)
    for name in ("TPU_CORE_VMEM_BYTES", "LANES", "V5E_HBM_BW"):
        assert not hasattr(io_model, name)
    # the sp engine rounds its prefill bucket to sp * SUBLANES rows, as the
    # reference's does, so that the chunks are the JAX engine's
    assert io_model.SUBLANES == ref_io.SUBLANES
    # one source for the kernels' shared memory
    assert tuning.fwd_smem_bytes is io_model.fwd_smem_bytes
    assert tuning.bwd_smem_bytes is io_model.bwd_smem_bytes
    assert tuning.SMEM_PER_BLOCK == io_model.H100_SMEM_PER_BLOCK
    for d in tuning.KERNEL_HEAD_DIMS:
        for bf16, paged in ((False, False), (True, False), (True, True)):
            fwd = io_model.fwd_smem_bytes(64, 64, d, bf16=bf16, paged=paged)
            bwd = io_model.bwd_smem_bytes(64, 64, d, bf16=bf16, paged=paged)
            assert io_model.attention_working_set_bytes(
                64, 64, d, bf16=bf16, paged=paged, backward=False) == fwd
            assert io_model.attention_working_set_bytes(
                64, 64, d, bf16=bf16, paged=paged) == max(fwd, bwd)


@pytest.mark.parametrize("fwd_and_bwd", [True, False])
def test_attention_counts_bit_equal(fwd_and_bwd):
    for n, d, heads, batch, elt in itertools.product(NS, DS, [1, 12], [1, 4],
                                                     [2, 4]):
        _eq(io_model.standard_attention_hbm_bytes(n, d, heads, batch, elt,
                                                  fwd_and_bwd),
            ref_io.standard_attention_hbm_bytes(n, d, heads, batch, elt,
                                                fwd_and_bwd))
        for sram in (ref_io.A100_SRAM_BYTES, 48 * 1024, 1000.0):
            _eq(io_model.flash_attention_hbm_bytes(n, d, heads, batch, sram,
                                                   elt, fwd_and_bwd),
                ref_io.flash_attention_hbm_bytes(n, d, heads, batch, sram,
                                                 elt, fwd_and_bwd))
            _eq(io_model.flash_attention_hbm_bytes(n, d, heads, batch, sram,
                                                   elt, fwd_and_bwd, 64),
                ref_io.flash_attention_hbm_bytes(n, d, heads, batch, sram,
                                                 elt, fwd_and_bwd, 64))
            for density in (1.0, 0.25, 0.1):
                _eq(io_model.blocksparse_flash_hbm_bytes(
                        n, d, heads, batch, sram, density, elt, fwd_and_bwd),
                    ref_io.blocksparse_flash_hbm_bytes(
                        n, d, heads, batch, sram, density, elt, fwd_and_bwd))
        for recompute in (True, False):
            _eq(io_model.attention_flops(n, d, heads, batch, fwd_and_bwd,
                                         recompute),
                ref_io.attention_flops(n, d, heads, batch, fwd_and_bwd,
                                       recompute))


def test_tile_counts_bit_equal():
    for (nq, nk), d, (bq, bk) in itertools.product(
            [(64, 64), (256, 1536), (2048, 2048), (100, 37)], DS, BLOCKS):
        for kv_major, density, fb in itertools.product(
                (False, True), (1.0, 0.3), (True, False)):
            _eq(io_model.flash_hbm_bytes_tiled(nq, nk, d, 8, 2, bq, bk, 2, fb,
                                               density, kv_major),
                ref_io.flash_hbm_bytes_tiled(nq, nk, d, 8, 2, bq, bk, 2, fb,
                                             density, kv_major))
        for hq, hkv in ((32, 8), (4, 4)):
            _eq(io_model.prefill_order_hbm_bytes(nq, nk, d, hq, hkv, 2, bq,
                                                 bk, 2, 0.5),
                ref_io.prefill_order_hbm_bytes(nq, nk, d, hq, hkv, 2, bq, bk,
                                               2, 0.5))
        _eq(io_model.gather_hbm_bytes(nk, d, 8, 2, 3),
            ref_io.gather_hbm_bytes(nk, d, 8, 2, 3))
        for cached in (0, 16, nk):
            _eq(io_model.prefix_cache_hbm_bytes_saved(cached, d, 32, 8, 2, 4,
                                                      bq),
                ref_io.prefix_cache_hbm_bytes_saved(cached, d, 32, 8, 2, 4,
                                                    bq))


def test_parallel_counts_bit_equal():
    for n, dm, shards in itertools.product([1, 17, 256], [64, 3072], [1, 2, 4]):
        _eq(io_model.tp_psum_hbm_bytes(n, dm, shards, 2, 2, 3),
            ref_io.tp_psum_hbm_bytes(n, dm, shards, 2, 2, 3))
        _eq(io_model.tp_sharded_hbm_bytes(1e9, shards, n, dm, 2, 2, 3),
            ref_io.tp_sharded_hbm_bytes(1e9, shards, n, dm, 2, 2, 3))
    for chunk, prefix, d, sp in itertools.product([64, 300], [0, 1024], DS,
                                                  [1, 2, 4]):
        _eq(io_model.sp_prefill_hbm_bytes(chunk, prefix, d, 32, 8, sp,
                                          block_q=64, elt=2, layers=3),
            ref_io.sp_prefill_hbm_bytes(chunk, prefix, d, 32, 8, sp,
                                        block_q=64, elt=2, layers=3))


PRICE_KW = [dict(), dict(kv_major=True), dict(tp=2), dict(sp=2),
            dict(sp=4, sp_strategy="ring"), dict(tp=2, sp=2,
                                                 sp_strategy="allgather")]


@pytest.mark.parametrize("kw", PRICE_KW)
def test_price_model_and_ledger_equal_reference(kw):
    geo = dict(d=96, heads_q=32, heads_kv=32, d_model=3072, layers=32, elt=2,
               block_q=64, block_k=64, kv_major=False)
    geo.update(kw)
    ours, ref = ServePriceModel(**geo), RefPrice(**geo)
    for spans in ([(0, 640)], [(0, 100), (0, 37), (512, 64)], [(5, 0)]):
        _eq(ours.prefill_bytes(spans), ref.prefill_bytes(spans))
    for kv_lens in ([640], [0, 17, 1000], []):
        _eq(ours.decode_bytes(kv_lens), ref.decode_bytes(kv_lens))
    led, rled = IOLedger(ours), RefLedger(ref)
    for args in (("prefill_zero", 1e9, 0.01, 640), ("decode", 5e8, 0.002, 4),
                 ("decode", 5e8, 0.003, 4), ("prefix_saved", 1e8, 0.0, 32)):
        for ledger in (led, rled):
            ledger.account(args[0], hbm_bytes=args[1], wall_s=args[2],
                           tokens=args[3])
    assert led.summary() == rled.summary()
    assert led.table() == rled.table()
    _eq(led.total_bytes(), rled.total_bytes())
    _eq(led.bytes_per_token(), rled.bytes_per_token())
    assert IOLedger().bytes_per_token() == 0.0


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced_config("granite-3-2b")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


PROMPTS = [[5, 9, 2], [7, 7, 1, 4], [3], [11, 2], [8, 6, 5, 1, 9],
           list(range(1, 20))]
SHARED = list(range(1, 33))
CASES = {
    # name: (engine kwargs, prompts, new tokens, sequential submit)
    "atomic": (dict(num_slots=3, capacity=64), PROMPTS[:5], 6, False),
    "chunked": (dict(num_slots=3, capacity=64, page_size=8, chunk_size=5,
                     token_budget=11), PROMPTS, 6, False),
    "prefix_hit": (dict(num_slots=2, capacity=64, page_size=8, chunk_size=8),
                   [SHARED + [40, 41, 42], SHARED + [50, 51]], 6, True),
    "preemption": (dict(num_slots=2, capacity=32, page_size=8, chunk_size=8,
                        token_budget=18, num_pages=4),
                   [list(range(1, 25)), list(range(30, 54))], 5, False),
}


def _serve(engine, prompts, n_new, sequential):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
        if sequential:
            engine.run()
    engine.run()
    return {r.rid: r.output for r in engine.finished}


def _step_spans(doc):
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "step"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_ledger_counts_match_jax_and_price_with_port_tiles(weights,
                                                                  case):
    jmodel, jparams, np_params = weights
    kw, prompts, n_new, seq = CASES[case]
    jeng = JaxEngine(jmodel, jparams, paged=True, trace=True, **kw)
    want = _serve(jeng, prompts, n_new, seq)
    cfg = reduced_config("granite-3-2b")
    eng = ServingEngine(build_model(cfg),
                        params_from_jax(np_params, cfg, device="cpu"),
                        trace=True, device="cpu", **kw)
    assert _serve(eng, prompts, n_new, seq) == want

    ours, ref = eng.tm.ledger.by_kind, jeng.tm.ledger.by_kind
    assert {k: (c["steps"], c["tokens"]) for k, c in ours.items()} == \
        {k: (c["steps"], c["tokens"]) for k, c in ref.items()}
    assert eng.prefill_hbm_bytes_saved == jeng.prefill_hbm_bytes_saved
    assert eng.prefill_gather_bytes_eliminated == \
        jeng.prefill_gather_bytes_eliminated
    if case == "prefix_hit":
        assert eng.prefill_hbm_bytes_saved > 0
        assert ours["prefix_saved"]["hbm_bytes"] == eng.prefill_hbm_bytes_saved
    if case == "chunked":
        assert eng.prefill_gather_bytes_eliminated > 0

    # the port's own price: the forward kernel's tiles, q-major
    price = eng.tm.ledger.price
    assert (price.block_q, price.block_k, price.kv_major) == (64, 64, False)
    model_at_port_tiles = RefPrice(
        d=cfg.head_dim, heads_q=cfg.num_heads, heads_kv=cfg.num_kv_heads,
        d_model=cfg.d_model, layers=cfg.num_layers, elt=4, block_q=64,
        block_k=64, kv_major=False)
    doc = chrome_trace_doc(eng.tm.tracer.events)
    totals = {}
    for ev in _step_spans(doc):
        a = ev["args"]
        if ev["name"] == "decode":
            rows = [a["kv_rows"]] + [0] * (a["tokens"] - 1)
            hbm = model_at_port_tiles.decode_bytes(rows)
        else:
            hbm = model_at_port_tiles.prefill_bytes(
                [tuple(c) for c in a["chunks"]])
        assert a["hbm_bytes"] == pytest.approx(hbm, rel=1e-12)
        assert a["tiles"]["block_q"] == 64 and a["tiles"]["kv_major"] is False
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + a["hbm_bytes"]
    for kind, total in totals.items():
        assert ours[kind]["hbm_bytes"] == pytest.approx(total, rel=1e-12)
        assert ours[kind]["wall_s"] > 0
    assert len(eng.ttfts) == len(prompts) and eng.tok_latencies
    assert "GB/s" in eng.tm.ledger.table()


def test_dense_engine_prices_its_steps(weights):
    """Dense slots: the same per-kind steps and tokens as the JAX dense
    engine, every step priced."""
    jmodel, jparams, np_params = weights
    kw = dict(num_slots=3, capacity=64)
    jeng = JaxEngine(jmodel, jparams, paged=False, **kw)
    want = _serve(jeng, PROMPTS[:5], 4, False)
    cfg = reduced_config("granite-3-2b")
    eng = ServingEngine(build_model(cfg),
                        params_from_jax(np_params, cfg, device="cpu"),
                        paged=False, device="cpu", **kw)
    assert _serve(eng, PROMPTS[:5], 4, False) == want
    ours, ref = eng.tm.ledger.by_kind, jeng.tm.ledger.by_kind
    assert {k: (c["steps"], c["tokens"]) for k, c in ours.items()} == \
        {k: (c["steps"], c["tokens"]) for k, c in ref.items()}
    assert all(c["hbm_bytes"] > 0 for c in ours.values())


@pytest.mark.parametrize("case", ["chunked", "preemption"])
def test_trace_passes_both_validators(weights, case, tmp_path, capsys):
    _, _, np_params = weights
    kw, prompts, n_new, seq = CASES[case]
    cfg = reduced_config("granite-3-2b")
    eng = ServingEngine(build_model(cfg),
                        params_from_jax(np_params, cfg, device="cpu"),
                        trace=True, device="cpu", **kw)
    _serve(eng, prompts, n_new, seq)
    if case == "preemption":
        assert eng.preemptions > 0
    doc = chrome_trace_doc(eng.tm.tracer.events)
    assert validate_chrome_trace(doc) == [] == ref_validate(doc)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    assert validate.main([str(path)]) == 0
    assert "trace OK" in capsys.readouterr().out


def test_validators_agree_on_broken_traces(weights):
    _, _, np_params = weights
    cfg = reduced_config("granite-3-2b")
    eng = ServingEngine(build_model(cfg),
                        params_from_jax(np_params, cfg, device="cpu"),
                        trace=True, device="cpu", num_slots=2, capacity=64)
    _serve(eng, PROMPTS[:3], 3, False)
    doc = chrome_trace_doc(eng.tm.tracer.events)
    unpriced = json.loads(json.dumps(doc))
    for ev in _step_spans(unpriced):
        del ev["args"]["hbm_bytes"]
    no_finish = json.loads(json.dumps(doc))
    no_finish["traceEvents"] = [e for e in no_finish["traceEvents"]
                                if e.get("name") != "finish"]
    for broken in (unpriced, no_finish, {}, {"traceEvents": "nope"}):
        probs = validate_chrome_trace(broken)
        assert probs and probs == ref_validate(broken)
