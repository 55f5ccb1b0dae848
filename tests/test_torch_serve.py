"""Serving parity on the CPU: the port's ``ServingEngine`` gives greedy
tokens IDENTICAL to the JAX ``ServingEngine`` for the same weights — atomic
and chunked prefill, prefix-cache hits, and forced preemption -> resume —
both through the ``chunked`` attention and through the kernels' plain
versions (``attn_impl="pallas"``, ``use_decode_kernel=True``), including
one JAX run whose Pallas kernels execute in interpret mode. Plus the
port's own sampling invariants, and the card-path guards: entry points
without ``device="cpu"`` raise when CUDA is absent."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced_config("granite-3-2b")
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(np_params, impl="chunked"):
    cfg = reduced_config("granite-3-2b", attn_impl=impl,
                         use_decode_kernel=impl == "pallas")
    return build_model(cfg), params_from_jax(np_params, cfg, device="cpu")


def _serve(engine, prompts, n_new, sequential=False, **submit_kw):
    for p in prompts:
        engine.submit(p, max_new_tokens=n_new, **submit_kw)
        if sequential:
            engine.run()
    engine.run()
    return {r.rid: r.output for r in engine.finished}


PAGED_KV_PROMPTS = [[5, 9, 2], [7, 7, 1, 4], [3], [11, 2], [8, 6, 5, 1, 9]]
CHUNK_PROMPTS = PAGED_KV_PROMPTS + [list(range(1, 20))]
SHARED = list(range(1, 33))

CASES = {
    # name: (engine kwargs, prompts, new tokens, sequential submit)
    "atomic": (dict(num_slots=3, capacity=64), PAGED_KV_PROMPTS, 6, False),
    "chunked": (dict(num_slots=3, capacity=64, page_size=8, chunk_size=5,
                     token_budget=11), CHUNK_PROMPTS, 6, False),
    "prefix_hit": (dict(num_slots=2, capacity=64, page_size=8, chunk_size=8),
                   [SHARED + [40, 41, 42], SHARED + [50, 51]], 6, True),
    "preemption": (dict(num_slots=2, capacity=32, page_size=8, chunk_size=8,
                        token_budget=18, num_pages=4),
                   [list(range(1, 25)), list(range(30, 54))], 5, False),
    # a page the card's kernels refuse (> 64 rows) still serves on the CPU
    "page_128": (dict(num_slots=2, capacity=256, page_size=128, chunk_size=8),
                 CHUNK_PROMPTS, 4, False),
}


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax_engine(weights, case, impl):
    jmodel, jparams, np_params = weights
    kw, prompts, n_new, seq = CASES[case]
    ref = _serve(JaxEngine(jmodel, jparams, paged=True, **kw), prompts,
                 n_new, seq)
    model, params = _port(np_params, impl)
    eng = ServingEngine(model, params, device="cpu", **kw)
    assert _serve(eng, prompts, n_new, seq) == ref
    if case == "prefix_hit":
        assert eng.prefix_hits == 1 and eng.prefill_tokens_skipped == 32
    if case == "preemption":
        assert eng.preemptions >= 1, "scenario no longer forces preemption"
    assert eng.kv.used_pages == 0


def test_sharer_preemption_identical_to_jax_engine(weights):
    """Two sharers of a primed prefix under pool pressure: the younger is
    preempted and resumes token-identically (tests/test_prefix_cache.py)."""
    jmodel, jparams, np_params = weights
    kw = dict(num_slots=2, capacity=32, page_size=8, chunk_size=8,
              token_budget=18, num_pages=5)
    shared = list(range(1, 17))

    def drive(engine):
        engine.submit(shared + [60], max_new_tokens=2)
        engine.run()
        engine.submit(shared + [61, 62, 63, 64], max_new_tokens=8)
        engine.submit(shared + [71, 72, 73, 74], max_new_tokens=8)
        engine.run()
        return {r.rid: r.output for r in engine.finished}

    ref = drive(JaxEngine(jmodel, jparams, paged=True, **kw))
    model, params = _port(np_params, "pallas")
    eng = ServingEngine(model, params, device="cpu", **kw)
    assert drive(eng) == ref
    assert eng.preemptions >= 1 and eng.prefix_hits >= 1


def test_jax_pallas_interpret_engine_matches_port(weights):
    """The JAX engine with its Pallas kernels (interpret mode) on the path
    — packed prefill, paged chunk prefill, paged decode — against the port
    engine's kernel path (plain versions on CPU)."""
    _, jparams, np_params = weights
    jcfg = jax_reduced_config("granite-3-2b", attn_impl="pallas",
                              use_decode_kernel=True)
    kw = dict(num_slots=2, capacity=32, page_size=8, chunk_size=8)
    prompts = [list(range(3, 15)), [9, 4, 2]]
    ref = _serve(JaxEngine(jax_build_model(jcfg), jparams, paged=True, **kw),
                 prompts, 3)
    model, params = _port(np_params, "pallas")
    assert _serve(ServingEngine(model, params, device="cpu", **kw),
                  prompts, 3) == ref


def test_sampled_preemption_resume_identical_within_port(weights):
    """Sampling draws from a generator seeded by (seed, position): a forced
    preemption -> resume replays the same tokens as a calm pool."""
    _, _, np_params = weights
    model, params = _port(np_params, "pallas")

    def run(num_pages):
        eng = ServingEngine(model, params, num_slots=2, capacity=32,
                            page_size=8, chunk_size=8, token_budget=18,
                            num_pages=num_pages, device="cpu")
        eng.submit(list(range(1, 10)), max_new_tokens=12, temperature=0.8,
                   top_p=0.9, seed=3)
        eng.submit(list(range(30, 40)), max_new_tokens=12, temperature=1.2,
                   top_p=0.8, seed=4)
        eng.run()
        return {r.rid: r.output for r in eng.finished}, eng

    calm, _ = run(8)
    tight, eng = run(4)
    assert eng.preemptions >= 1
    assert tight == calm


def test_sampling_temperature_zero_is_greedy_and_seeds_decorrelate(weights):
    _, _, np_params = weights
    model, params = _port(np_params)

    def one(**kw):
        eng = ServingEngine(model, params, num_slots=1, capacity=64,
                            device="cpu")
        return _serve(eng, [[5, 9, 2, 7]], 8, **kw)[0]

    assert one() == one(temperature=0.0, seed=9)
    a, b = one(temperature=1.5, seed=1), one(temperature=1.5, seed=2)
    assert a == one(temperature=1.5, seed=1)
    assert a != b


def test_entry_points_raise_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the guard does not apply")
    _, _, np_params = weights
    model, params = _port(np_params)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params, num_slots=2, capacity=32)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(np_params, model.cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--reduced", "--requests", "1"])


def test_unported_modes_raise(weights):
    _, _, np_params = weights
    model, params = _port(np_params)
    # tp / sp serve one rank a shard over a ServeMesh: reduced granite's
    # single kv head cannot split over tp=2 (the reference's check), and
    # sp=2 without a mesh is refused
    with pytest.raises(ValueError, match="kv heads"):
        ServingEngine(model, params, num_slots=2, capacity=32,
                      device="cpu", tp=2)
    with pytest.raises(ValueError, match="mesh="):
        ServingEngine(model, params, num_slots=2, capacity=32,
                      device="cpu", sp=2)
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(model, params, num_slots=2, capacity=32,
                      device="meta")
    # a pinned decode split count that does not divide the pages per
    # sequence fails at construction, not inside the first decode step
    cfg = reduced_config("granite-3-2b", use_decode_kernel=True,
                         num_decode_splits=4)
    with pytest.raises(ValueError, match="num_splits"):
        ServingEngine(build_model(cfg), params, num_slots=2, capacity=96,
                      device="cpu")


def test_launcher_smoke_on_cpu(capsys):
    eng = launch_serve.main(["--smoke", "--device", "cpu"])
    assert eng.preemptions >= 1 and eng.prefix_hits >= 1
    assert "tok/s" in capsys.readouterr().out
    cfg = launch_serve.model_config(launch_serve.build_parser().parse_args(
        ["--device", "cuda"]))
    assert cfg.num_layers == 40 and cfg.d_model == 2048      # published
    assert cfg.attn_impl == "pallas" and cfg.use_decode_kernel
