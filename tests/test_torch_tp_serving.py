"""Tensor-parallel paged serving in the port (DESIGN.md §13), as SPMD
ranks over gloo on the CPU (``repro_torch.distributed``): tp = 2, 4 and 8
ranks, one spawn each, every rank running the same ``ServingEngine`` over
its head slice of the reduced granite-3-2b (heads 8/4 at tp 2 and 4,
16/8 at tp 8), with weights from the JAX ``Model.init``.

  * greedy tokens identical to the JAX engine's at tp=1 through greedy and
    sampled lanes, a duplicate prompt that hits the prefix cache, and
    preemption under a small pool; every token (sampled too) identical to
    the port's tp=1; every rank's tokens the same;
  * packed-prefill logits within 1e-5 of the port's tp=1 and 1e-4 of the
    JAX model, the same bits on every rank;
  * each rank's pool the head slice of the tp=1 pool, its
    ``per_shard_cache_bytes`` a tp-th of its ``cache_bytes``, which is
    tp=1's (the reference's meanings: a rank's, and the sum over shards);
  * the census: decode, the zero-offset packed prefill and the chunk step
    each count ``2 * num_layers`` ``all_reduce`` calls and nothing else;
  * ``backend="nccl"`` with more ranks than cards refused before any
    collective; the construction errors in the reference's words;
    ``validate_divisibility`` naming its offender; ``param_specs`` equal
    to the reference's leaf for leaf; ``shard_params`` equal to numpy
    slices; the decode split target scaled by tp (capped on the card);
  * the serve launcher at ``--tp 2`` printing once and serving the tokens
    of ``--tp 1``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_ranks import (CFG_KW, greedy_rids, jax_serve, port_serve, ranks,
                          wave, weights)
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import tuning as jax_tuning
from repro.models import build_model as jax_build_model
from repro_torch.configs import reduced_config
from repro.distributed import sharding as jax_sharding
from repro_torch.distributed.sharding import (P, auto_rules, resolve_spec,
                                              rules_for_mesh, shard_params,
                                              sp_serve_rules, tp_serve_rules,
                                              validate_divisibility)
from repro_torch.kernels import tuning
from repro_torch.models import build_model
from repro_torch.serve import ServingEngine

torch.set_num_threads(1)
TPS = [2, 4, 8]
HEADS = {2: 8, 4: 8, 8: 16}
L = CFG_KW["num_layers"]

_rng = np.random.default_rng(0)
_DUP = list(map(int, _rng.integers(1, 128, size=12)))
_OTHERS = [list(map(int, _rng.integers(1, 128, size=n))) for n in (7, 9)]
_rng = np.random.default_rng(1)
_LONG = [list(map(int, _rng.integers(1, 128, size=10))) for _ in range(4)]
_rng = np.random.default_rng(2)
_POOL = [list(map(int, _rng.integers(1, 128, size=n))) for n in (11, 6, 17)]
PACKED = {"tokens": _rng.integers(1, 128, size=(1, 24)).astype(np.int32),
          "segment_ids": np.array([[0] * 9 + [1] * 11 + [-1] * 4], np.int32)}

# the scenarios every tp serves (the reference's test_tp_serving and
# test_tp_page_pool_slicing_property): a prefix hit of a primed duplicate
# through greedy and sampled lanes; preemption under a 10-page pool; the
# pool and a packed prefill's logits
SCENARIOS = {
    "prefix": dict(engine=dict(chunk_size=4),
                   waves=[wave([_DUP]), wave([_OTHERS[0], _DUP,
                                              _OTHERS[1]])]),
    "preempt": dict(engine=dict(num_pages=10, chunk_size=4,
                                prefix_cache=False),
                    waves=[wave(_LONG, max_new=14)]),
    "pool": dict(engine=dict(num_slots=3), waves=[wave(_POOL, max_new=6)],
                 pool=True, packed=PACKED),
}
NAMES = list(SCENARIOS)


@functools.lru_cache(maxsize=None)
def served(tp):
    """Every rank's records of the scenarios at ``tp`` (one spawn); at tp=2
    first a refused nccl mesh."""
    runs = [dict(SCENARIOS[n], sp=1, tp=tp) for n in NAMES]
    if tp == 2:
        runs.insert(0, dict(mesh_only=True, sp=1, tp=2, backend="nccl"))
    out = ranks(HEADS[tp], tp, runs)
    return [recs[-len(NAMES):] for recs in out], [recs[0] for recs in out]


@functools.lru_cache(maxsize=None)
def baseline(heads, name):
    """(JAX tp=1 tokens, or None for the pool scenario, whose tokens are
    held to the port's alone; port tp=1 tokens; port tp=1 engine)."""
    sc = SCENARIOS[name]
    jout = (None if name == "pool"
            else jax_serve(heads, sc["waves"], **sc["engine"])[0])
    pout, peng = port_serve(heads, sc["waves"], **sc["engine"])
    return jout, pout, peng


@pytest.mark.parametrize("tp", TPS)
def test_tokens_equal_jax_and_port_tp1(tp):
    records, _ = served(tp)
    heads = HEADS[tp]
    for i, name in enumerate(NAMES):
        sc = SCENARIOS[name]
        jout, pout, peng = baseline(heads, name)
        outs = [recs[i]["outputs"] for recs in records]
        assert all(o == outs[0] for o in outs), f"{name}: ranks disagree"
        got = outs[0]
        assert set(got) == set(pout)
        for rid in greedy_rids(sc["waves"]) if jout is not None else ():
            assert got[rid] == jout[rid], (name, rid)
        assert got == pout, name          # sampled lanes included
        rec = records[0][i]
        assert rec["preemptions"] == peng.preemptions
        assert rec["prefix_hits"] == peng.prefix_hits
    assert records[0][NAMES.index("preempt")]["preemptions"] > 0
    assert records[0][NAMES.index("prefix")]["prefix_hits"] > 0


@pytest.mark.parametrize("tp", TPS)
def test_packed_logits_and_pool_slices(tp):
    records, _ = served(tp)
    heads = HEADS[tp]
    cfg, params, _, jmodel, jparams = weights(heads)
    i = NAMES.index("pool")
    _, _, peng = baseline(heads, "pool")
    with torch.inference_mode():
        _, want = build_model(cfg).prefill_packed(
            params, {k: torch.as_tensor(v) for k, v in PACKED.items()})
    _, jl = jmodel.prefill_packed(jparams, {k: jax.numpy.asarray(v)
                                            for k, v in PACKED.items()})
    got = [recs[i]["packed_logits"] for recs in records]
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    live = PACKED["segment_ids"][0] >= 0
    np.testing.assert_allclose(got[0][:, live], want.numpy()[:, live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0][:, live], np.asarray(jl)[:, live],
                               atol=1e-4, rtol=0)
    hkv = cfg.num_kv_heads // tp
    for recs in records:
        rec = recs[i]
        j = rec["coord"][1]
        for name, pool in rec["pool"].items():
            full = peng.state["caches"]["kv"][name].numpy()
            assert pool.shape[1] == hkv
            np.testing.assert_allclose(pool, full[:, j * hkv:(j + 1) * hkv],
                                       rtol=1e-5, atol=1e-6)
        assert (rec["per_shard_cache_bytes"] * tp == rec["cache_bytes"]
                == peng.cache_bytes())


@pytest.mark.parametrize("tp", TPS)
def test_census_all_reduce_only(tp):
    records, _ = served(tp)
    want = {"all_reduce": 2 * L}
    for recs in records:
        census = recs[NAMES.index("prefix")]["step_census"]
        assert census == {"prefill_zero": want, "prefill_chunk": want,
                          "decode": want}, census


def test_nccl_without_a_card_a_rank_refused_before_any_collective():
    """Every rank raises while building the mesh, before it creates a
    group: the spawn's later runs (which build their groups in step) all
    complete."""
    records, refused = served(2)
    for rec in refused:
        assert "nccl" in rec["error"] and "2 cards" in rec["error"]
    assert all(len(recs) == len(NAMES) for recs in records)


def test_construction_errors():
    cfg, params, _, _, _ = weights(8)
    model = build_model(cfg)
    kw = dict(num_slots=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="kv heads.*not divisible"):
        ServingEngine(model, params, tp=8, **kw)          # hkv 4 % 8
    cfg_ff = reduced_config("granite-3-2b", **{**CFG_KW, "d_ff": 130})
    with pytest.raises(ValueError, match="d_ff"):
        ServingEngine(build_model(cfg_ff), params, tp=4, **kw)
    with pytest.raises(ValueError, match="dense slot mode"):
        ServingEngine(model, params, paged=False, tp=2, **kw)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        ServingEngine(model, params, tp=0, **kw)
    with pytest.raises(ValueError, match="mesh="):
        ServingEngine(model, params, tp=2, **kw)
    moe = reduced_config("olmoe-1b-7b", dtype="float32")
    with pytest.raises(ValueError, match="family 'moe' is out of scope"):
        ServingEngine(build_model(moe), params, tp=2, **kw)


def test_validate_divisibility_names_offender():
    problems = validate_divisibility({"w": torch.zeros((6, 8))},
                                     {"w": P("heads", None)}, {"tp": 4},
                                     rules={"heads": "tp"})
    assert problems == [
        "/w: shape (6, 8) spec PartitionSpec('tp', None) — dim[0]=6 not "
        "divisible by mesh axes ('tp',) (size 4)"]


def _jax_specs(tree, stacked):
    if isinstance(tree, JP):
        t = tuple(tree)
        return t[1:] if stacked else t
    if isinstance(tree, dict):
        return {k: _jax_specs(v, stacked) for k, v in tree.items()}
    return [_jax_specs(v, stacked) for v in tree]


def _tuples(tree):
    if isinstance(tree, tuple):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return [_tuples(v) for v in tree]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_specs_equal_reference(arch):
    """Leaf for leaf, once the reference's stacked layer axis is dropped."""
    jcfg = jax_reduced_config(arch)
    ref = dict(jax_build_model(jcfg).param_specs())
    for key, n in (("blocks", jcfg.num_layers),
                   ("enc_blocks", jcfg.num_encoder_layers)):
        if key in ref:
            v = ref[key]
            ref[key] = ([_jax_specs(v, True)] * n if isinstance(v, dict)
                        else [_jax_specs(b, False) for b in v])
    ref = {k: v if k in ("blocks", "enc_blocks") else _jax_specs(v, False)
           for k, v in ref.items()}
    assert _tuples(build_model(reduced_config(arch)).param_specs()) == ref


class _Mesh:
    """What the reference's rule helpers read off a jax Mesh."""

    def __init__(self, **shape):
        self.shape, self.axis_names = shape, tuple(shape)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_rule_tables_equal_reference(arch):
    """``rules_for_mesh`` and ``auto_rules`` (vocab, experts, d_ff, heads,
    SSM widths and the batch demoted where they do not divide) equal to
    the reference's, and the serving tables."""
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    for shape in ({"data": 2, "model": 16}, {"pod": 2, "data": 4,
                                             "model": 3}):
        mesh = _Mesh(**shape)
        assert rules_for_mesh(shape) == jax_sharding.rules_for_mesh(mesh)
        for batch in (None, 6):
            assert (auto_rules(cfg, shape, global_batch=batch)
                    == jax_sharding.auto_rules(jcfg, mesh,
                                               global_batch=batch))
    assert tp_serve_rules() == jax_sharding.tp_serve_rules()
    assert sp_serve_rules() == jax_sharding.sp_serve_rules()
    assert resolve_spec(P("heads", None), sp_serve_rules()) == ("tp", None)
    assert resolve_spec(P(("pod", "data"), "sp_seq"),
                        rules_for_mesh({"pod": 2})) == (("pod", "data"),
                                                        None)


class _Rank:
    """The shape and coordinate ``shard_params`` reads off a ServeMesh."""

    def __init__(self, sp, tp, coord):
        self.shape, self.coord = {"sp": sp, "tp": tp}, coord


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_equal_numpy_slices(tp):
    cfg, params, np_params, _, _ = weights(8)
    hd, hq, hkv = cfg.head_dim, cfg.num_heads // tp, cfg.num_kv_heads // tp
    ff = cfg.d_ff // tp
    specs = build_model(cfg).param_specs()
    for j in range(tp):
        got = shard_params(params, specs, _Rank(1, tp, (0, j)),
                           tp_serve_rules())
        assert got["embed"] is params["embed"]
        for l, (blk, full) in enumerate(zip(got["blocks"],
                                            np_params["blocks"])):
            a, fa = blk["attn"], full["attn"]
            np.testing.assert_array_equal(
                a["wq"].numpy(), fa["wq"][:, j * hq * hd:(j + 1) * hq * hd])
            for name in ("wk", "wv"):
                np.testing.assert_array_equal(
                    a[name].numpy(),
                    fa[name][:, j * hkv * hd:(j + 1) * hkv * hd])
            np.testing.assert_array_equal(
                a["wo"].numpy(), fa["wo"][j * hq * hd:(j + 1) * hq * hd])
            m, fm = blk["mlp"], full["mlp"]
            for name in ("w_gate", "w_up"):
                np.testing.assert_array_equal(
                    m[name].numpy(), fm[name][:, j * ff:(j + 1) * ff])
            np.testing.assert_array_equal(m["w_down"].numpy(),
                                          fm["w_down"][j * ff:(j + 1) * ff])
            np.testing.assert_array_equal(blk["attn_norm"]["w"].numpy(),
                                          full["attn_norm"]["w"])


def test_decode_split_target_scales_with_tp():
    for shards in (1, 2, 4, 8):
        assert (tuning.decode_split_target(shards)
                == jax_tuning.decode_split_target(shards))
        assert (tuning.decode_split_target(shards, on_card=True)
                == min(tuning.decode_split_target(shards),
                       tuning.MAX_DECODE_SPLITS) == 8)


def test_launcher_tp2_serves_the_tokens_of_tp1(capfd):
    from repro_torch.launch import serve as launch_serve
    argv = ["--smoke", "--device", "cpu", "--arch", "olmo-1b"]
    eng = launch_serve.main(argv)
    want = {r.rid: r.output for r in eng.finished}
    capfd.readouterr()
    got = launch_serve.main(argv + ["--tp", "2"])
    out = capfd.readouterr().out
    assert len(got) == 2 and all(g == want for g in got)
    assert out.count("tok/s") == 1 and "tp=2 sp=1" in out
