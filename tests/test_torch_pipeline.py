"""GPipe pipeline parallelism in the port (``distributed.pipeline``) as
four SPMD ranks over gloo on the CPU (one spawn;
``repro_torch.distributed.launch.pipeline_rank``, each rank importing
only ``repro_torch``), at the reference test's size and on its inputs:
L 8 residual tanh layers of D 16, a global batch of 8 in M 4
microbatches, 4 stages.

  * the forward on every rank within rtol 1e-5 / atol 1e-6 of the
    sequential stack and of the JAX ``pipeline_apply``;
  * the gradient of sum(y²) (each rank its stage's layers) within rtol
    1e-4 / atol 1e-5 of the sequential stack's, and within rtol 1e-4 /
    atol 1e-5 x max|g| of ``jax.grad`` through the JAX pipeline: the
    gradient's entries reach ~35, and the two frameworks' float32 sums
    differ there by up to ~2e-5 (the port's sequential stack is as far
    from JAX's pipeline as the port's pipeline is);
  * the collectives: M + S - 1 ring shifts forward, as many backward but
    the last tick's, one all-reduce for the output's broadcast;
  * ``split_stages`` / ``make_stage_fn`` as the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import make_stage_fn as jax_make_stage_fn
from repro.distributed.pipeline import pipeline_apply as jax_pipeline_apply
from repro.distributed.pipeline import split_stages as jax_split_stages
from repro_torch.distributed import launch
from repro_torch.distributed.pipeline import (make_stage_fn, split_stages,
                                              tanh_block)

L, D, GB, M, S = 8, 16, 8, 4, 4


@functools.lru_cache(maxsize=None)
def inputs():
    """The reference test's weights and input, drawn as it draws them."""
    keys = jax.random.split(jax.random.PRNGKey(0), L)
    w = jnp.stack([jax.random.normal(k, (D, D)) * 0.3 for k in keys])
    x = jax.random.normal(jax.random.PRNGKey(1), (GB, D))
    return np.asarray(w, np.float32), np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def ranks():
    w, x = inputs()
    return launch.spawn(S, launch.pipeline_rank, {
        "w": w, "x": x, "num_microbatches": M, "device": "cpu",
        "backend": "gloo"})


def sequential(w, x):
    for l in range(L):
        x = torch.tanh(x @ w[l]) + x
    return x


@functools.lru_cache(maxsize=None)
def jax_pipeline():
    """The JAX pipeline's forward and gradient on a 4-device mesh."""
    w, x = inputs()
    mesh = jax.make_mesh((S,), ("pipe",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def block(p_l, h):
        return jnp.tanh(h @ p_l["w"]) + h

    stage_fn = jax_make_stage_fn(block)

    def loss(w):
        y = jax_pipeline_apply(stage_fn, jax_split_stages({"w": w}, S),
                               jnp.asarray(x), mesh=mesh, num_microbatches=M)
        return (y ** 2).sum(), y

    (_, y), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w))
    return np.asarray(y), np.asarray(g)


def test_forward_matches_sequential_and_jax():
    w, x = inputs()
    want = sequential(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    jy, _ = jax_pipeline()
    for r in ranks():
        np.testing.assert_allclose(r["y"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["y"], jy, rtol=1e-5, atol=1e-6)


def test_gradients_match_sequential_and_jax():
    w, x = inputs()
    wt = torch.from_numpy(w).requires_grad_()
    sequential(wt, torch.from_numpy(x)).square().sum().backward()
    got = sum(r["grad"] for r in ranks())
    np.testing.assert_allclose(got, wt.grad.numpy(), rtol=1e-4, atol=1e-5)
    jg = jax_pipeline()[1]
    np.testing.assert_allclose(got, jg, rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))
    per_stage = L // S
    for r in ranks():           # each rank's gradient is its stage's
        s = r["stage"]
        mine = r["grad"][s * per_stage:(s + 1) * per_stage]
        assert np.abs(mine).max() > 0
        rest = np.delete(r["grad"], range(s * per_stage, (s + 1) * per_stage),
                         axis=0)
        assert not rest.any()


def test_collectives_per_tick():
    for r in ranks():
        assert r["census"] == {"ring_shift": 2 * (M + S - 1) - 1,
                               "all_reduce": 1}


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
def test_split_stages_and_stage_fn_equal_reference(stages):
    w, x = inputs()
    got = split_stages({"w": torch.from_numpy(w)}, stages)["w"]
    want = jax_split_stages({"w": jnp.asarray(w)}, stages)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = make_stage_fn(tanh_block)({"w": got[0]}, torch.from_numpy(x))
    jy = jax_make_stage_fn(lambda p, h: jnp.tanh(h @ p["w"]) + h)(
        {"w": want[0]}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        split_stages({"w": torch.from_numpy(w)}, 3)
