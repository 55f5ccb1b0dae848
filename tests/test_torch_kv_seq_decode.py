"""The sequence-sharded decode (``train.steps.make_sharded_serve_steps``:
the KV capacity, or the page pool's pages, cut over "model", each rank's
split partials merged across ranks) as gloo ranks on the CPU
(``distributed.launch.kv_seq``, one spawn of 2 ranks and one of 4, each
rank importing only ``repro_torch``), against the reference's
``make_sharded_serve_steps`` on the conftest's 8 CPU host devices (its
params, prefill state and tokens ``device_put`` to the step's shardings
first), weights from the JAX ``Model.init``:

  * reduced granite-3-2b at (data 1, model 2), (data 2, model 2) and
    (data 1, model 4), the slot cache and the page pool: a prompt that
    spans the slice boundary, lanes that cross it during decode, lanes
    shorter than r C / m (ranks with nothing to attend), and a windowed
    config whose window straddles the boundary;
  * reduced olmoe-1b-7b (experts cut; slots and pages), mamba2-2.7b (by
    SSM head group), hymba-1.5b (heads, SSM head groups, MLP) and
    phi-3-vision-4.2b (patches ahead of the prompt) at model 2, and
    seamless-m4t-medium (the encoder tensor-parallel, the cross cache's
    64 encoder rows cut over "model" too) at model 2 and data 2 x model
    2.

Each case: every rank's state piece after the prefill equal to its
piece of the reference's state within 1e-5 (the pool in the interleaved
layout of ``transformer.interleaved_page_table``, the reference's cut
to it), 6 greedy decode steps with identical tokens and logits within
1e-4, every step's census equal to ``expected_kv_seq_decode_census`` on
every rank, and each rank's decode-state bytes equal to the dry-run's
per-rank estimate (``launch.dryrun.decode_state_bytes``). The contract:
``donate=False`` leaves the input state unchanged, ``rules=None`` on a
vocab that does not divide raises naming the leaf (as the reference's
placement refuses it), and ``state_specs=None`` is the single-rank
decode.
"""

import concurrent.futures
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

from repro.configs import reduced_config as jax_reduced_config
from repro.distributed.sharding import auto_rules as jax_auto_rules
from repro.distributed.sharding import resolve_spec as jax_resolve_spec
from repro.distributed.sharding import resolve_tree as jax_resolve_tree
from repro.distributed.sharding import rules_for_mesh as jax_rules_for_mesh
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tfm
from repro.train.steps import \
    make_sharded_serve_steps as jax_make_sharded_serve_steps
from repro_torch.configs import ShapeConfig, reduced_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import launch
from repro_torch.distributed.sharding import (auto_rules,
                                              expected_kv_seq_decode_census,
                                              shard_params)
from repro_torch.launch.dryrun import decode_state_bytes
from repro_torch.models import build_model, params_from_jax

torch.set_num_threads(1)
LANES, CAP, PAGE, STEPS = 2, 64, 8, 6

# name: (arch, (data, model), state, prompt length, config overrides);
# capacity 64: slices of 32 at model 2, of 16 at model 4
CASES = {
    # the lanes' writes cross the boundary at 32 in decode step 4
    "dense_m2": ("granite-3-2b", (1, 2), "contiguous", 29, {}),
    # the prompt spans the boundary
    "dense_m2_span": ("granite-3-2b", (1, 2), "contiguous", 40, {}),
    "dense_dp2_m2": ("granite-3-2b", (2, 2), "contiguous", 29, {}),
    "dense_m4": ("granite-3-2b", (1, 4), "contiguous", 29, {}),
    # lanes shorter than every slice but rank 0's: ranks 1-3 attend none
    "dense_m4_short": ("granite-3-2b", (1, 4), "contiguous", 10, {}),
    "paged_m2": ("granite-3-2b", (1, 2), "paged", 40, {}),
    "paged_m2_cross": ("granite-3-2b", (1, 2), "paged", 29, {}),
    "paged_dp2_m2": ("granite-3-2b", (2, 2), "paged", 29, {}),
    "paged_m4_short": ("granite-3-2b", (1, 4), "paged", 10, {}),
    # a window of 8 across the boundary: the ranks' lower edge is global
    "window_m2": ("granite-3-2b", (1, 2), "contiguous", 29, {"window": 8}),
    "window_m4": ("granite-3-2b", (1, 4), "contiguous", 29, {"window": 8}),
    "olmoe_m2": ("olmoe-1b-7b", (1, 2), "contiguous", 29, {}),
    "olmoe_m2_paged": ("olmoe-1b-7b", (1, 2), "paged", 29, {}),
    "mamba2_m2": ("mamba2-2.7b", (1, 2), "contiguous", 29, {}),
    "hymba_m2": ("hymba-1.5b", (1, 2), "contiguous", 29, {}),
    # 8 patches + 20 tokens: the writes cross 32 in decode step 5
    "phi3v_m2": ("phi-3-vision-4.2b", (1, 2), "contiguous", 20, {}),
    # CAP encoder rows, their cross cache cut over "model" too
    "seamless_m2": ("seamless-m4t-medium", (1, 2), "contiguous", 29, {}),
    "seamless_dp2_m2": ("seamless-m4t-medium", (2, 2), "contiguous", 29,
                        {}),
}
# the contract's runs, beside the cases in the spawn of 2 ranks
DONATE_OFF = "dense_m2"
NO_RULES_VOCAB = 255          # does not cut over 2 ranks


def world(name):
    d, m = CASES[name][1]
    return d * m


def _batch(cfg, prompt, seed=3):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab_size, (LANES, prompt)
                                ).astype(np.int32)}
    if cfg.num_encoder_layers:
        b["frames"] = rng.standard_normal(
            (LANES, CAP, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (LANES, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def weights(name):
    """(port cfg, numpy params in the port's layout, JAX model, JAX
    params)."""
    arch, _, _, _, kw = CASES[name]
    jmodel = jax_build_model(jax_reduced_config(arch, **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config(arch, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, tree_map(lambda t: t.numpy(), params), jmodel, jparams


def to_pages(cache):
    """A slot cache (L, B, hkv, C, hd) as a pool of pages of ``PAGE`` in the
    interleaved layout: logical page t of lane b at page t * B + b."""
    L, B, hkv, C, hd = cache.shape
    T = C // PAGE
    return cache.reshape(L, B, hkv, T, PAGE, hd).transpose(
        0, 2, 3, 1, 4, 5).reshape(L, hkv, T * B, PAGE, hd)


def _reference(name):
    """The reference's sharded serve steps over the case's mesh: its
    prefill state (numpy; the pool in the interleaved layout for a paged
    case), tokens (B, STEPS + 1) and logits (B, STEPS + 1, V), prefill
    first."""
    arch, shape, state, prompt, _ = CASES[name]
    cfg, _, jmodel, jparams = weights(name)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = jax_auto_rules(jmodel.cfg, mesh)
    if state == "paged":
        specs = jmodel.paged_decode_state_specs()
    else:
        specs = {"caches": jax_tfm.decode_cache_specs(
                     jmodel.cfg, enc=jmodel.cfg.num_encoder_layers > 0),
                 "kv_len": JaxP("data")}
    prefill, decode = jax_make_sharded_serve_steps(jmodel, mesh, rules=rules,
                                                   state_specs=specs)
    params = jax.device_put(jparams, jax_resolve_tree(jmodel.param_specs(),
                                                      mesh, rules))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, prompt).items()}
    st, logits = prefill(params, batch, CAP)
    st = jax.tree.map(np.asarray, st)
    if state == "paged":
        T = CAP // PAGE
        st = {"caches": {"kv": {k: to_pages(c) for k, c in
                                st["caches"]["kv"].items()}},
              "page_table": (np.arange(T)[None, :] * LANES
                             + np.arange(LANES)[:, None]).astype(np.int32),
              "kv_len": st["kv_len"]}
    first = st
    st = jax.device_put(st, jax_resolve_tree(specs, mesh, rules))
    tok_sh = JaxNamedSharding(mesh, jax_resolve_spec(JaxP("data"), rules))
    toks = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    lgs = [np.asarray(logits[:, -1], np.float32)]
    for _ in range(STEPS):
        tok = jax.device_put(jnp.asarray(toks[-1], jnp.int32), tok_sh)
        st, logits = decode(params, st, tok)
        toks.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
        lgs.append(np.asarray(logits[:, -1], np.float32))
    return first, np.stack(toks, 1), np.stack(lgs, 1)


@functools.lru_cache(maxsize=None)
def _references():
    """Every case's reference, computed in threads (XLA compiles outside
    the GIL): {name: future}."""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futures = {n: pool.submit(_reference, n) for n in CASES}
    pool.shutdown(wait=False)
    return futures


def reference(name):
    return _references()[name].result()


def run(name, **kw):
    arch, shape, state, prompt, _ = CASES[name]
    cfg, params, _, _ = weights(name)
    return dict({"cfg": cfg, "params": params, "shape": shape,
                 "state": state, "rules": "auto",
                 "batch": _batch(cfg, prompt), "capacity": CAP,
                 "steps": STEPS, "page_size": PAGE, "keep_state": True},
                **kw)


def _contract_runs():
    cfg, params, _, _ = weights(DONATE_OFF)
    odd = reduced_config("granite-3-2b", vocab_size=NO_RULES_VOCAB)
    odd_params = tree_map(lambda t: t.numpy(),
                          build_model(odd).init(torch.Generator()
                                                .manual_seed(0), "cpu"))
    return {"donate_off": run(DONATE_OFF, donate=False),
            "no_rules": dict(run(DONATE_OFF), cfg=odd, params=odd_params,
                             rules=None, expect_error=True),
            "unsharded": run(DONATE_OFF, state=None)}


def _spawn(n):
    names = [c for c in CASES if world(c) == n]
    runs = [run(c) for c in names]
    if n == 2:
        extra = _contract_runs()
        names += list(extra)
        runs += list(extra.values())
    # each run holds its config and params (the cases differ in them)
    out = launch.kv_seq({"backend": "gloo", "device": "cpu", "runs": runs},
                        n)
    return {c: [recs[i] for recs in out] for i, c in enumerate(names)}


@functools.lru_cache(maxsize=None)
def spawned():
    """Both spawns started at once, in threads, then the references:
    {world: future of {name: records by rank}}."""
    for name in CASES:
        weights(name)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {n: pool.submit(_spawn, n) for n in (2, 4)}
    pool.shutdown(wait=False)
    _references()
    return futures


@pytest.fixture(scope="module", autouse=True)
def _start_ranks():
    spawned()


def records(name):
    n = 2 if name not in CASES else world(name)
    return spawned()[n].result()[name]


class _Rank:
    """A mesh as one rank sees it, enough for ``shard_params``."""

    def __init__(self, axes, coord):
        self.shape, self.named_coord = axes, coord


def _pieces_equal(got, want, specs, axes, coord, rules):
    """The rank's state piece ``got`` against its piece of the reference's
    state ``want``, cut by ``shard_params``. The port's encoder-decoder
    state also holds ``enc_len`` (its single rank's cross cache is
    padded), the reference's does not."""
    specs = {k: v for k, v in specs.items() if k in want}
    piece = shard_params(tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  {k: want[k] for k in specs}),
                         specs, _Rank(axes, coord), rules)
    for path, g, w in zip(_paths(specs), tree_leaves(_like(got, specs)),
                          tree_leaves(piece)):
        assert g.shape == tuple(w.shape), path
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=0,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w.numpy(), err_msg=path)


def _like(tree, specs):
    """``tree``'s entries in ``specs``' order."""
    if isinstance(specs, dict):
        return {k: _like(tree[k], specs[k]) for k in specs}
    return tree


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{path}/{k}")]
    return [path]


def _axes(name):
    d, m = CASES[name][1]
    return {"data": d, "model": m}


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_state_is_the_reference_piece(name):
    cfg = weights(name)[0]
    model = build_model(cfg)
    specs = (model.paged_decode_state_specs() if CASES[name][2] == "paged"
             else model.decode_state_specs())
    axes = _axes(name)
    rules = auto_rules(cfg, axes)
    want, _, _ = reference(name)
    for r in records(name):
        _pieces_equal(r["prefill_state"], want, specs, axes, r["coord"],
                      rules)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_reference(name):
    _, tokens, logits = reference(name)
    recs = records(name)
    covered = set()
    for r in recs:
        lo, hi = r["lanes"]
        covered.update(range(lo, hi))
        np.testing.assert_array_equal(r["tokens"], tokens[lo:hi])
        np.testing.assert_allclose(r["logits"], logits[lo:hi], atol=1e-4,
                                   rtol=0)
    assert covered == set(range(LANES))


@pytest.mark.parametrize("name", list(CASES))
def test_census_exact_on_every_rank(name):
    cfg = weights(name)[0]
    d, m = CASES[name][1]
    want = expected_kv_seq_decode_census(
        cfg, m, data=d, paged=CASES[name][2] == "paged",
        rules=auto_rules(cfg, _axes(name)))
    for r in records(name):
        assert r["expected_census"] == want
        assert len(r["census"]) == STEPS
        for c in r["census"]:
            assert c == want, (r["rank"], c)


def test_census_counts_by_hand():
    """granite at model 2 (heads, d_ff and vocab 256 cut): per layer the
    token's columns and the partials gathered, ``wo`` and ``w_down``
    summed; per step the embedding summed and the logits gathered; a
    pool every data rank holds adds one gather of the lanes' tables."""
    cfg = weights("dense_m2")[0]
    L = cfg.num_layers
    assert expected_kv_seq_decode_census(cfg, 2) == {
        "all_gather": 2 * L + 1, "all_reduce": 2 * L + 1}
    assert expected_kv_seq_decode_census(cfg, 2, data=2, paged=True) == {
        "all_gather": 2 * L + 2, "all_reduce": 2 * L + 1}
    mamba = weights("mamba2_m2")[0]
    assert expected_kv_seq_decode_census(mamba, 2) == {
        "all_reduce": 2 * mamba.num_layers + 1, "all_gather": 1}
    assert expected_kv_seq_decode_census(cfg, 1) == {}


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_equal_the_dry_run(name):
    cfg = weights(name)[0]
    axes = _axes(name)
    paged = CASES[name][2] == "paged"
    # the dry-run's decode cell at this capacity and lane count (an
    # encoder-decoder's cell splits its length between the two streams)
    seq = 2 * CAP if cfg.num_encoder_layers else CAP
    want = decode_state_bytes(cfg, axes, auto_rules(cfg, axes),
                              ShapeConfig(name, seq, LANES, "decode"),
                              page_size=PAGE if paged else None)
    for r in records(name):
        assert r["state_bytes"] == want


def test_donate_false_leaves_the_state():
    for r in records("donate_off"):
        assert r["input_state_unchanged"]
    # donated, the state is written in place: the first step's new K/V
    # (position 29) lands on rank 0, whose slice holds it
    for r in records(DONATE_OFF):
        assert r["input_state_unchanged"] == (r["coord"]["model"] != 0)
    _, tokens, logits = reference(DONATE_OFF)
    for r in records("donate_off"):
        np.testing.assert_array_equal(r["tokens"], tokens)


def test_rules_none_on_an_odd_vocab_refused():
    for r in records("no_rules"):
        assert "sharding preflight failed" in r["error"]
        assert "/embed" in r["error"] and "255" in r["error"]


def test_reference_refuses_the_odd_vocab_too():
    odd = jax_reduced_config("granite-3-2b", vocab_size=NO_RULES_VOCAB)
    jmodel = jax_build_model(odd)
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    sh = jax_resolve_tree(jmodel.param_specs(), mesh,
                          jax_rules_for_mesh(mesh))
    with pytest.raises(ValueError):
        jax.device_put(jnp.zeros(shapes["embed"].shape), sh["embed"])


def test_unsharded_state_is_the_single_rank_decode():
    _, tokens, logits = reference(DONATE_OFF)
    cfg = weights(DONATE_OFF)[0]
    for r in records("unsharded"):
        np.testing.assert_array_equal(r["tokens"], tokens)
        np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)
        assert r["census"] == [{}] * STEPS
        full = build_model(cfg).init_decode_state(LANES, CAP, device="meta")
        assert r["state_bytes"] == sum(
            math.prod(t.shape) * t.element_size()
            for t in [*full["caches"]["kv"].values(), full["kv_len"]])
