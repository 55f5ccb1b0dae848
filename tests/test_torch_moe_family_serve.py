"""Serving the reference's mixture-of-experts decoders on the CPU, against
the JAX engine with the same weights (``params_from_jax``): reduced
olmoe-1b-7b and phi3.5-moe-42b-a6.6b (8 experts, top-2; GQA 4:1 for
phi3.5). Every packed prefill row, prefill chunk and decode step routes
its tokens per row with capacity dropping, so the packed row's requests
compete for expert capacity as in the reference.

  * the port's ``ServingEngine`` gives greedy tokens identical to the JAX
    engine's, paged — atomic and chunked prefill, a prefix-cache hit,
    forced preemption -> resume — and dense (fixed slots, packed
    prefill), at the default capacity factor 1.25 (tokens dropped) and at
    8 (none dropped), through the ``chunked`` attention and the kernels'
    plain versions (``attn_impl="pallas"``, ``use_decode_kernel=True``);
  * the serve launcher on both archs with ``--reduced --device cpu``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
SHARED = list(range(1, 33))
PROMPTS = [[5, 9, 2], [7, 7, 1, 4], [3], [11, 2], [8, 6, 5, 1, 9],
           list(range(40, 59))]
CASES = {
    # name: (engine kwargs, prompts, new tokens, sequential submit)
    "atomic": (dict(paged=True, num_slots=3, capacity=64), PROMPTS, 6,
               False),
    "chunked": (dict(paged=True, num_slots=3, capacity=64, page_size=8,
                     chunk_size=5, token_budget=11), PROMPTS, 6, False),
    "prefix_hit": (dict(paged=True, num_slots=2, capacity=64, page_size=8,
                        chunk_size=8),
                   [SHARED + [40, 41, 42], SHARED + [50, 51]], 6, True),
    "preemption": (dict(paged=True, num_slots=2, capacity=32, page_size=8,
                        chunk_size=8, token_budget=18, num_pages=4),
                   [list(range(1, 25)), list(range(30, 54))], 5, False),
    "dense": (dict(paged=False, num_slots=3, capacity=64), PROMPTS, 6, False),
}


@pytest.fixture(scope="module", params=[(a, cf) for a in ARCHS
                                        for cf in (1.25, 8.0)],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def family(request):
    arch, cf = request.param
    jmodel = jax_build_model(jax_reduced_config(arch, moe_capacity_factor=cf))
    params = jmodel.init(jax.random.PRNGKey(0))
    return arch, cf, jmodel, params, jax.tree.map(np.asarray, params)


def _serve(engine, prompts, n_new, sequential):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
        if sequential:
            engine.run()
    engine.run()
    return {r.rid: r.output for r in engine.finished}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax_engine(family, case):
    arch, cf, jmodel, jparams, np_params = family
    kw, prompts, n_new, seq = CASES[case]
    ref = _serve(JaxEngine(jmodel, jparams, **kw), prompts, n_new, seq)
    for impl in ("chunked", "pallas"):
        cfg = reduced_config(arch, moe_capacity_factor=cf, attn_impl=impl,
                             use_decode_kernel=impl == "pallas")
        eng = ServingEngine(build_model(cfg),
                            params_from_jax(np_params, cfg, device="cpu"),
                            device="cpu", **kw)
        assert _serve(eng, prompts, n_new, seq) == ref, impl
        if case == "prefix_hit":
            assert eng.prefix_hits == 1 and eng.prefill_tokens_skipped == 32
        if case == "preemption":
            assert eng.preemptions >= 1, "scenario no longer forces preemption"
        if kw["paged"]:
            assert eng.kv.used_pages == 0


def test_default_capacity_drops_tokens_in_the_served_rows(family):
    """The default capacity factor really drops (token, expert) choices in
    the rows the engine serves (packed prefill of several requests), and
    the factor 8 drops none: the parity above covers both."""
    from repro_torch.models import moe

    arch, cf, _, _, np_params = family
    cfg = reduced_config(arch, moe_capacity_factor=cf)
    dropped, route = [], moe.dispatch_maps

    def watch(idx, e, cap):
        maps = route(idx, e, cap)
        dropped.append(int((maps[2] == e * cap).sum()))
        return maps

    moe.dispatch_maps = watch
    try:
        eng = ServingEngine(build_model(cfg),
                            params_from_jax(np_params, cfg, device="cpu"),
                            device="cpu", **CASES["atomic"][0])
        _serve(eng, PROMPTS, 3, False)
    finally:
        moe.dispatch_maps = route
    assert (sum(dropped) > 0) == (cf == 1.25)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_takes_the_moe_archs(arch, dense):
    from repro_torch.launch import serve as launch_serve

    eng = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "2", "--max-new", "4"]
                            + (["--dense"] if dense else []))
    assert eng.model.cfg.name == arch and eng.model.cfg.family == "moe"
    assert eng.paged != dense
    assert len(eng.finished) == 2 and all(r.output for r in eng.finished)
