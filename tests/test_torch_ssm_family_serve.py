"""Serving the reference's state-space and hybrid decoders on the CPU,
against the JAX engine with the same weights (``params_from_jax``):
reduced mamba2-2.7b and hymba-1.5b (window 64, GQA 4:1). Neither family
can page or pack: both engines choose dense slots, prefill each request
unpadded in a batch-1 call, and decode every slot's recurrent state.

  * the port's ``ServingEngine`` gives greedy tokens identical to the JAX
    engine's, with prompts that are not a multiple of the SSM chunk (16)
    and prompts longer than hymba's window, through the ``chunked``
    attention and the kernels' plain versions (``attn_impl="pallas"``,
    ``use_decode_kernel=True``);
  * no leak from a slot's last occupant or idle steps: a request admitted
    into a slot that decoded another request (and idled) gives the tokens
    of a fresh engine, also one shorter than the conv's w-1 rows;
  * ``paged=True``, ``chunk_size`` and ``prefix_cache=True`` are refused
    as the reference refuses them, with its messages;
  * the serve launcher on both archs with ``--reduced --device cpu``.
"""

import re

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
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
_RNG = np.random.default_rng(0)
# 3 slots, 4 requests: one waits for a slot that decoded and idled
PROMPTS = [[int(t) for t in _RNG.integers(1, 256, n)] for n in (21, 70, 5, 90)]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced_config(arch))
    params = jmodel.init(jax.random.PRNGKey(0))
    return arch, jmodel, params, jax.tree.map(np.asarray, params)


def _serve(engine, prompts, n_new):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new)
    engine.run()
    return {r.rid: r.output for r in engine.finished}


def _engine(arch, np_params, impl="pallas", **kw):
    cfg = reduced_config(arch, attn_impl=impl,
                         use_decode_kernel=impl == "pallas")
    return ServingEngine(build_model(cfg),
                         params_from_jax(np_params, cfg, device="cpu"),
                         device="cpu", **kw)


def test_greedy_tokens_identical_to_jax_engine(family):
    arch, jmodel, jparams, np_params = family
    jeng = JaxEngine(jmodel, jparams, num_slots=3, capacity=128)
    assert not jeng.paged and not jeng.packed_prefill
    ref = _serve(jeng, PROMPTS, 6)
    for impl in ("chunked", "pallas"):
        eng = _engine(arch, np_params, impl, num_slots=3, capacity=128)
        assert not eng.paged and not eng.packed_prefill
        assert _serve(eng, PROMPTS, 6) == ref, impl
        assert eng.prefill_calls == len(PROMPTS)


@pytest.mark.parametrize("late", [[7, 7, 1, 4, 9, 30, 2], [5, 9]])
def test_no_leak_from_a_slots_last_occupant(family, late):
    """One slot: the first request decodes in it, then the late one is
    admitted there; its tokens equal those of a fresh engine serving it
    alone (the whole slot state is overwritten: every layer's K/V rows,
    SSM state and conv rows, the latter only in part by a prompt of 2)."""
    arch, _, _, np_params = family
    used = _engine(arch, np_params, num_slots=1, capacity=128)
    out = _serve(used, [PROMPTS[1], late], 8)
    fresh = _engine(arch, np_params, num_slots=1, capacity=128)
    assert out[1] == _serve(fresh, [late], 8)[0]


def test_idle_lanes_do_not_leak(family):
    """Four slots, requests admitted at different steps: the idle slots
    decode (their state advances) before they are used; every request's
    tokens equal those of a fresh one-slot engine."""
    arch, _, _, np_params = family
    eng = _engine(arch, np_params, num_slots=4, capacity=128)
    eng.submit(PROMPTS[0], max_new_tokens=10)
    for _ in range(4):
        eng.step()
    eng.submit(PROMPTS[2], max_new_tokens=4)
    eng.run()
    got = {r.rid: r.output for r in eng.finished}
    for rid, prompt, n in ((0, PROMPTS[0], 10), (1, PROMPTS[2], 4)):
        fresh = _engine(arch, np_params, num_slots=1, capacity=128)
        assert got[rid] == _serve(fresh, [prompt], n)[0]


@pytest.mark.parametrize("kw", [dict(paged=True), dict(chunk_size=8),
                                dict(prefix_cache=True)],
                         ids=["paged", "chunk_size", "prefix_cache"])
def test_refused_as_the_reference_refuses(family, kw):
    arch, jmodel, jparams, np_params = family
    with pytest.raises(ValueError) as ref:
        JaxEngine(jmodel, jparams, num_slots=2, capacity=64, **kw)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        _engine(arch, np_params, num_slots=2, capacity=64, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_picks_dense_slots(arch, capsys):
    from repro_torch.launch import serve as launch_serve

    eng = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4",
                             "--long-prompt", "70"])
    assert not eng.paged
    assert len(eng.finished) == 4
    assert all(len(r.output) >= 1 for r in eng.finished)
    assert "mode=dense slots=4x128" in capsys.readouterr().out
