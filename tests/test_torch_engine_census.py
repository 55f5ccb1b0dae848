"""The serving engine's census and shard-size helpers (port of the
reference's ``ServingEngine.decode_collective_census``,
``prefill_collective_census``, ``cache_bytes`` / ``per_shard_cache_bytes``
and ``queue``), on the reduced granite-3-2b of the tp/sp serving tests
(``tests/_torch_ranks.py``): gloo ranks on the CPU at tp 2 and 4 (one
spawn of 2 ranks, one of 4 with sp 2 x tp 2 beside it).

  * the censuses come from the step functions run on placeholder inputs,
    before the first step and again after serving, on every rank: decode
    ``2 L`` ``all_reduce`` (at sp > 1 too), the chunk step
    ``expected_sp_prefill_census``, the packed prefill ``2 L``
    ``all_reduce`` at sp 1, the scatter ``{}``; "packed" and "scatter" at
    sp > 1 and an unknown kind raise; the placeholder steps leave the
    engine's pool, counters and census as they were;
  * ``per_shard_cache_bytes() * tp == cache_bytes()``, the latter the
    tp=1 engine's;
  * unsharded and dense engines give ``{}``; ``queue`` lists the pending
    requests in service order.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_ranks import ENGINE, port_serve, ranks, wave, weights
from repro_torch.distributed.sharding import expected_sp_prefill_census
from repro_torch.models import build_model
from repro_torch.serve import ServingEngine

L = 2
PROMPTS = [list(range(3, 40)), list(range(50, 61)), list(range(70, 100))]
WAVES = [wave(PROMPTS, max_new=4)]
MESHES = {(1, 2): 8, (1, 4): 8, (2, 2): 8}     # (sp, tp): q heads


@functools.lru_cache(maxsize=None)
def served(world):
    runs = [{"sp": sp, "tp": tp, "waves": WAVES, "census": True,
             "sp_strategy": "allgather" if sp > 1 else None,
             "engine": {"chunk_size": 16} if sp > 1 else {}}
            for (sp, tp) in MESHES if sp * tp == world]
    out = ranks(8, world, runs)
    names = [m for m in MESHES if m[0] * m[1] == world]
    return {m: [recs[i] for recs in out] for i, m in enumerate(names)}


def records(mesh):
    return served(mesh[0] * mesh[1])[mesh]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_censuses_are_the_reference_contract(mesh):
    sp, tp = mesh
    chunk = expected_sp_prefill_census(L, sp=sp, strategy="allgather")
    for r in records(mesh):
        for census in (r["census_before"], r["census_after"]):
            assert census["decode"] == {"all_reduce": 2 * L}
            assert census["chunk"] == chunk
            if sp == 1:
                assert census["packed"] == {"all_reduce": 2 * L}
                assert census["scatter"] == {}
            else:
                assert census["packed"].startswith("ValueError")
                assert census["scatter"].startswith("ValueError")
            assert census["bogus"].startswith(
                "ValueError: unknown prefill census kind")
        # the census counts what the steps count when they serve
        steps = r["step_census"]
        assert steps["decode"] == r["census_before"]["decode"]
        if sp == 1:
            assert steps["prefill_zero"] == r["census_before"]["packed"]
        else:
            assert steps["prefill_chunk"] == chunk


@pytest.mark.parametrize("mesh", list(MESHES))
def test_census_leaves_the_engine_as_it_was(mesh):
    for r in records(mesh):
        assert r["census_left_engine"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_bytes_sum_the_shards(mesh):
    sp, tp = mesh
    _, eng = port_serve(8, WAVES)
    for r in records(mesh):
        assert r["per_shard_cache_bytes"] * tp == r["cache_bytes"]
        assert r["cache_bytes"] == eng.cache_bytes()
        assert eng.per_shard_cache_bytes() == eng.cache_bytes()


def test_tokens_match_the_single_rank():
    want, _ = port_serve(8, WAVES)
    greedy = [i for i, r in enumerate(WAVES[0]) if r["temperature"] == 0.0]
    for mesh in MESHES:
        for r in records(mesh):
            assert {i: r["outputs"][i] for i in greedy} == \
                {i: want[i] for i in greedy}


@pytest.mark.parametrize("paged", [True, False])
def test_unsharded_census_is_empty(paged):
    cfg, params, _, _, _ = weights(8)
    eng = ServingEngine(build_model(cfg), params, device="cpu",
                        paged=paged, **{k: v for k, v in ENGINE.items()
                                        if paged or k != "page_size"})
    assert eng.decode_collective_census() == {}
    for kind in ("chunk", "packed", "scatter", "bogus"):
        assert eng.prefill_collective_census(kind) == {}


def test_queue_in_service_order():
    cfg, params, _, _, _ = weights(8)
    eng = ServingEngine(build_model(cfg), params, device="cpu", **ENGINE)
    rids = [eng.submit(p, max_new_tokens=2) for p in PROMPTS * 2]
    assert [r.rid for r in eng.queue] == rids
    eng.step()
    waiting = [r.rid for r in eng.queue]
    assert waiting == rids[len(rids) - len(waiting):]
    assert len(waiting) < len(rids)
    eng.run()
    assert eng.queue == []
    assert np.all([len(r.output) == 2 for r in eng.finished])
    assert torch.is_tensor(eng.state["caches"]["kv"]["k"])
