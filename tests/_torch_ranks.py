"""Shared by tests/test_torch_tp_serving.py and tests/test_torch_sp_serving.py:
the reduced granite-3-2b of the reference's tp/sp tests (float32, 2 layers,
d 64, heads 8/4 of 8 or 16/8 of 4, d_ff 128, vocab 128) with its weights
from the JAX ``Model.init``, the tp=1 serves of the JAX engine and of the
port, and the ranks' serves (``repro_torch.distributed.launch.serve``,
spawned: a rank imports the port alone, never a test module or jax)."""

import functools

import jax
import numpy as np

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import ServingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.core.tree import tree_map
from repro_torch.distributed import launch
from repro_torch.models import build_model, params_from_jax
from repro_torch.serve import ServingEngine

CFG_KW = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=4,
              head_dim=8, d_ff=128, vocab_size=128, dtype="float32")
CFG_KW16 = dict(CFG_KW, num_heads=16, num_kv_heads=8, head_dim=4)
ENGINE = dict(num_slots=4, capacity=64, page_size=8)


@functools.lru_cache(maxsize=None)
def weights(heads: int):
    """(port cfg, port params, their numpy tree, JAX model, JAX params) of
    the config with ``heads`` q heads (8 or 16)."""
    kw = CFG_KW if heads == 8 else CFG_KW16
    jmodel = jax_build_model(jax_reduced_config("granite-3-2b", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced_config("granite-3-2b", **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, tree_map(lambda t: t.numpy(), params), jmodel, jparams


def wave(prompts, max_new=8):
    """Requests as the reference's ``_drive`` submits them: odd ones
    sampled at temperature 0.7, seeds 23, 24, ..."""
    return [{"prompt": p, "max_new": max_new,
             "temperature": 0.7 if i % 2 else 0.0, "seed": 23 + i}
            for i, p in enumerate(prompts)]


def greedy_rids(waves) -> list[int]:
    flat = [r for w in waves for r in w]
    return [rid for rid, r in enumerate(flat) if r["temperature"] == 0.0]


def jax_serve(heads, waves, **kw):
    """The JAX engine at tp=1: tokens by rid, preemptions, prefix hits."""
    _, _, _, jmodel, jparams = weights(heads)
    eng = JaxEngine(jmodel, jparams, paged=True, **{**ENGINE, **kw})
    for w in waves:
        for r in w:
            eng.submit(r["prompt"], max_new_tokens=r["max_new"],
                       temperature=r["temperature"], seed=r["seed"])
        eng.run()
    return {r.rid: list(r.output) for r in eng.finished}, eng


def port_serve(heads, waves, **kw):
    """The port's engine at tp=1 on the CPU: tokens by rid, and the
    engine."""
    cfg, params, _, _, _ = weights(heads)
    eng = ServingEngine(build_model(cfg), params, device="cpu",
                        **{**ENGINE, **kw})
    return launch.serve_waves(eng, waves), eng


def ranks(heads, world, runs):
    """``runs`` served by ``world`` spawned ranks over gloo on the CPU:
    every rank's run records, by rank."""
    cfg, _, np_params, _, _ = weights(heads)
    spec = {"cfg": cfg, "params": np_params, "device": "cpu",
            "backend": "gloo",
            "runs": [dict(r, engine={**ENGINE, **r.get("engine", {})})
                     for r in runs]}
    return launch.serve(spec, world)
