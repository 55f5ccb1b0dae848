"""Sequence-parallel chunked prefill in the port (DESIGN.md §14), as SPMD
ranks over gloo on the CPU: (sp, tp) = (2, 1), (2, 2), (4, 1) and (4, 2),
each under both K/V strategies ("allgather", "ring"), one spawn for each
world size (2, 4, 8 ranks) on the reduced granite-3-2b of the reference's
tests (heads 8/4), with weights from the JAX ``Model.init``.

  * greedy tokens identical to the JAX engine's at tp=1, and every token
    (sampled lanes too) to the port's tp=1, on every rank: chunked prefill
    whose final slabs are ragged, atomic prefill (zero-offset chunks
    through the chunk step), preemption under a 10-page pool, and a
    prefix hit that leaves a 1-token suffix, so that every slab but the
    first holds only padding;
  * a chunk step's census equal to ``expected_sp_prefill_census`` (2L
    ``all_reduce`` plus L ``all_gather`` or (sp - 1)L ``ring_shift``),
    decode's ``2 * num_layers`` ``all_reduce`` alone, and no packed
    prefill at sp > 1;
  * ``resolve_sp_strategy``'s costs bit-equal to the reference's
    ``io_model.sp_prefill_hbm_bytes`` at 64-row tiles, its strategy their
    argmin; the census helper equal to the reference's in the port's
    kinds; the scheduler's chunk rounding and the engine's bucket rounding
    equal to the reference's; the construction errors, and a mesh larger
    than the world refused;
  * the serve launcher at ``--sp 2`` serving the tokens of ``--sp 1``.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_ranks import (CFG_KW, greedy_rids, jax_serve, port_serve, ranks,
                          wave, weights)
from repro.core import io_model as jax_io_model
from repro.distributed.sharding import \
    expected_sp_prefill_census as jax_expected_census
from repro.serve.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch.distributed.sharding import expected_sp_prefill_census
from repro_torch.kernels import tuning
from repro_torch.models import build_model
from repro_torch.serve import ServingEngine
from repro_torch.serve.scheduler import SchedulerConfig

torch.set_num_threads(1)
L = CFG_KW["num_layers"]
MESHES = [(2, 1), (2, 2), (4, 1), (4, 2)]
STRATEGIES = ["allgather", "ring"]
CASES = [(sp, tp, s) for sp, tp in MESHES for s in STRATEGIES]

_rng = np.random.default_rng(0)
_SWEEP = [list(map(int, _rng.integers(1, 128, size=n)))
          for n in (11, 7, 13, 9)]
_rng = np.random.default_rng(2)
_ATOMIC = [list(map(int, _rng.integers(1, 128, size=n))) for n in (11, 6, 14)]
_rng = np.random.default_rng(1)
_LONG = [list(map(int, _rng.integers(1, 128, size=10))) for _ in range(4)]
_rng = np.random.default_rng(3)
_DUP = list(map(int, _rng.integers(1, 128, size=17)))
_OTHER = list(map(int, _rng.integers(1, 128, size=9)))

# the reference's test_sp_serving scenarios: prompt lengths that are not
# multiples of sp * chunk (ragged final slabs); atomic prefill; preemption;
# a primed 17-token duplicate whose prefix hit leaves 1 row of a 64-row
# chunk step
SCENARIOS = {
    "sweep": dict(engine=dict(chunk_size=4), waves=[wave(_SWEEP)]),
    "atomic": dict(engine={}, waves=[wave(_ATOMIC)]),
    "preempt": dict(engine=dict(num_pages=10, chunk_size=4,
                                prefix_cache=False),
                    waves=[wave(_LONG, max_new=14)]),
    "slab": dict(engine=dict(chunk_size=8),
                 waves=[wave([_DUP]), wave([_OTHER, _DUP])]),
}
NAMES = list(SCENARIOS)


@functools.lru_cache(maxsize=None)
def served(world):
    """{(sp, tp, strategy): every rank's records of the scenarios} for the
    meshes of ``world`` ranks (one spawn); at 2 ranks first a refused
    2 x 2 mesh."""
    cases = [c for c in CASES if c[0] * c[1] == world]
    runs = [dict(SCENARIOS[n], sp=sp, tp=tp, sp_strategy=s)
            for sp, tp, s in cases for n in NAMES]
    lead = [dict(mesh_only=True, sp=2, tp=2, backend="gloo")] \
        if world == 2 else []
    out = ranks(8, world, lead + runs)
    per_case = {c: [recs[len(lead) + k * len(NAMES):
                         len(lead) + (k + 1) * len(NAMES)] for recs in out]
                for k, c in enumerate(cases)}
    return per_case, [recs[0] for recs in out] if lead else []


def case_records(sp, tp, strategy):
    return served(sp * tp)[0][(sp, tp, strategy)]


@functools.lru_cache(maxsize=None)
def baseline(name):
    sc = SCENARIOS[name]
    jout, _ = jax_serve(8, sc["waves"], **sc["engine"])
    pout, peng = port_serve(8, sc["waves"], **sc["engine"])
    return jout, pout, peng


@pytest.mark.parametrize("sp,tp,strategy", CASES)
def test_tokens_equal_jax_and_port_tp1(sp, tp, strategy):
    records = case_records(sp, tp, strategy)
    for i, name in enumerate(NAMES):
        sc = SCENARIOS[name]
        jout, pout, peng = baseline(name)
        outs = [recs[i]["outputs"] for recs in records]
        assert all(o == outs[0] for o in outs), f"{name}: ranks disagree"
        got = outs[0]
        for rid in greedy_rids(sc["waves"]):
            assert got[rid] == jout[rid], (name, rid)
        assert got == pout, name
        rec = records[0][i]
        assert rec["sp_strategy"] == strategy
        assert rec["preemptions"] == peng.preemptions
        assert rec["prefix_hits"] == peng.prefix_hits
        assert rec["prefill_tokens_skipped"] == peng.prefill_tokens_skipped
    assert records[0][NAMES.index("preempt")]["preemptions"] > 0
    slab = records[0][NAMES.index("slab")]
    assert slab["prefix_hits"] > 0 and slab["prefill_tokens_skipped"] == 16
    # the 1-row suffix rides a bucket of 64 rows: sp - 1 slabs of padding
    assert slab["prefill_bucket"] == 64


@pytest.mark.parametrize("sp,tp,strategy", CASES)
def test_chunk_step_census(sp, tp, strategy):
    for recs in case_records(sp, tp, strategy):
        for rec in recs:
            census = rec["step_census"]
            assert set(census) == {"prefill_chunk", "decode"}, census
            assert census["prefill_chunk"] == expected_sp_prefill_census(
                L, sp=sp, strategy=strategy)
            assert census["decode"] == {"all_reduce": 2 * L}


def test_mesh_larger_than_the_world_refused():
    for rec in served(2)[1]:
        assert rec["error"] == ("sp=2 x tp=2 needs 4 devices (one rank "
                                "each) but the process group has 2 ranks")


_KINDS = {"psum": "all_reduce", "all_gather": "all_gather",
          "ppermute": "ring_shift"}


def test_expected_census_equal_reference():
    for layers, sp, strategy in [(3, 4, "ring"), (3, 4, "allgather"),
                                 (2, 1, "allgather"), (40, 2, "ring")]:
        ref = jax_expected_census(layers, sp=sp, strategy=strategy)
        assert expected_sp_prefill_census(layers, sp=sp, strategy=strategy) \
            == {_KINDS[k]: n for k, n in ref.items()}
    with pytest.raises(ValueError):
        expected_sp_prefill_census(2, sp=2, strategy="teleport")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resolve_sp_strategy_costs_equal_reference(dtype):
    elt = {"float32": 4, "bfloat16": 2}[dtype]
    for chunk, prefix, d, hq, hkv, sp, layers in [
            (1024, 4096, 64, 8, 4, 4, 2), (128, 512, 64, 2, 2, 4, 1),
            (8192, 8192, 64, 8, 4, 4, 1), (256, 1056, 64, 16, 4, 2, 40),
            (64, 64, 8, 8, 4, 2, 2), (1024, 8192, 32, 2, 1, 1, 1)]:
        res = tuning.resolve_sp_strategy(chunk, prefix, d, heads_q=hq,
                                         heads_kv=hkv, sp=sp, dtype=dtype,
                                         layers=layers)
        # costed at the tuner's slab tile (the reference's rule, capped
        # at the kernels' 64 rows)
        slab = -(-chunk // sp)
        block_q = res["tiles"].block_q
        assert block_q == tuning.choose_tile_config(
            slab, prefix + chunk, d, dtype=dtype, backward=False,
            heads_q=hq, heads_kv=hkv, shards=sp).block_q <= 64
        ref = jax_io_model.sp_prefill_hbm_bytes(chunk, prefix, d, hq, hkv,
                                                sp, block_q=block_q, elt=elt,
                                                layers=layers)
        assert res["costs"] == ref and res["source"] == "analytic"
        if sp > 1:
            assert res["strategy"] == min(("allgather", "ring"),
                                          key=lambda s: ref[s])
        else:
            assert res["strategy"] == "allgather"


def test_scheduler_and_bucket_rounding_equal_reference():
    for chunk in (1, 4, 6, 8, 13, 256):
        for multiple in (1, 2, 4, 8):
            kw = dict(num_lanes=2, capacity=512, page_size=8,
                      chunk_size=chunk, chunk_multiple=multiple)
            assert (SchedulerConfig(**kw).chunk_size
                    == JaxSchedulerConfig(**kw).chunk_size)
    with pytest.raises(ValueError):
        SchedulerConfig(num_lanes=2, capacity=64, chunk_multiple=0)
    cfg, params, _, _, _ = weights(8)
    model = build_model(cfg)
    for bucket, sp in ((64, 2), (20, 4), (40, 2), (8, 4)):
        with pytest.raises(ValueError, match="mesh="):
            ServingEngine(model, params, num_slots=2, capacity=64,
                          prefill_bucket=bucket, sp=sp, device="cpu")
        m = sp * 8                        # the reference's SUBLANES
        want = bucket + (-bucket) % m
        eng = ServingEngine.__new__(ServingEngine)
        eng.paged, eng.prefill_bucket = True, bucket
        eng._check_parallel(cfg, 1, sp, None, 64, None)
        assert eng.prefill_bucket == want


def test_construction_errors():
    cfg, params, _, _, _ = weights(8)
    model = build_model(cfg)
    kw = dict(num_slots=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="sp must be >= 1"):
        ServingEngine(model, params, sp=0, **kw)
    with pytest.raises(ValueError, match="dense slot mode"):
        ServingEngine(model, params, paged=False, sp=2, **kw)
    with pytest.raises(ValueError, match="sp_strategy"):
        ServingEngine(model, params, sp=2, sp_strategy="teleport", **kw)


def test_launcher_sp2_serves_the_tokens_of_sp1(capfd):
    from repro_torch.launch import serve as launch_serve
    argv = ["--smoke", "--device", "cpu"]
    eng = launch_serve.main(argv)
    want = {r.rid: r.output for r in eng.finished}
    capfd.readouterr()
    got = launch_serve.main(argv + ["--sp", "2", "--sp-strategy",
                                    "allgather"])
    out = capfd.readouterr().out
    assert len(got) == 2 and all(g == want for g in got)
    assert out.count("tok/s") == 1 and "sp=2(allgather)" in out
