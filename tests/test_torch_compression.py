"""Int8 gradient compression in the port (``distributed.compression``)
against the reference's (``repro.distributed.compression``):

  * ``quantize`` / ``dequantize`` bit-equal to the reference's on
    gradients of several scales, zeros and ties at .5 included;
  * 50 error-feedback steps equal to the reference's, the residuals too;
  * ``init_residuals`` zeros in fp32 of every leaf's shape;
  * ``compressed_mean_tree`` over 8 gloo ranks (one spawn,
    ``repro_torch.distributed.launch.compression_rank``) within
    max|g| / 127 of the exact mean, the reference test's bound, and the
    same on every rank.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jax_compression
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import compression, launch

WORLD = 8


def grads(seed, scale=1.0, shape=(64, 33)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3e3])
def test_quantize_bit_equal_to_reference(scale):
    g = grads(1, scale)
    g[0, :5] = 0.0
    q, s = compression.quantize(torch.from_numpy(g))
    jq, js = jax_compression.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy(),
        np.asarray(jax_compression.dequantize(jq, js)))


def test_quantize_ties_and_zeros_as_reference():
    # exact halves after the scale: round half to even on both sides
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 0.0], np.float32)
    q, _ = compression.quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax_compression.quantize(jnp.asarray(g))[0]))
    q, s = compression.quantize(torch.zeros(4))
    assert not q.any() and s.item() == np.float32(1e-12)


def test_error_feedback_fifty_steps_equal_reference():
    tree = {"a": torch.zeros((16, 8)), "b": [torch.zeros((5,))]}
    res = compression.init_residuals(tree)
    assert all(r.dtype == torch.float32 and not r.any()
               for r in tree_leaves(res))
    jres = {"a": jnp.zeros((16, 8)), "b": [jnp.zeros((5,))]}
    for step in range(50):
        g = {"a": grads(step, 0.1, (16, 8)),
             "b": [grads(100 + step, 3.0, (5,))]}
        out, res = compression.error_feedback_update(
            {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]},
            res)
        jout, jres = jax_compression.error_feedback_update(
            {"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]}, jres)
        for got, want in ((out, jout), (res, jres)):
            np.testing.assert_array_equal(got["a"].numpy(),
                                          np.asarray(want["a"]))
            np.testing.assert_array_equal(got["b"][0].numpy(),
                                          np.asarray(want["b"][0]))


@functools.lru_cache(maxsize=None)
def spawned():
    g = grads(7, 1.0, (WORLD, 64))
    return g, launch.spawn(WORLD, launch.compression_rank,
                           {"g": g, "device": "cpu", "backend": "gloo"})


def test_compressed_mean_within_a_127th_of_the_max():
    g, out = spawned()
    exact = g.mean(axis=0)
    tol = float(np.abs(g).max()) / 127
    for r in out:
        np.testing.assert_array_equal(r["mean"], out[0]["mean"])
        assert np.abs(r["mean"] - exact).max() <= tol + 1e-6
    # the mean of each rank's own dequantized payload
    deq = [compression.dequantize(*compression.quantize(torch.from_numpy(x)))
           for x in g]
    np.testing.assert_allclose(out[0]["mean"],
                               (sum(deq) / WORLD).numpy(), rtol=1e-6,
                               atol=1e-7)
