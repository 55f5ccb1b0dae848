"""The paper's training recipe pieces against the JAX package, on the CPU,
from numpy seeds: ``lamb`` (the MLPerf-BERT optimizer) over three updates,
with and without weight decay, a zero-initialised bias leaf included (its
trust ratio is 1) and one all-zero gradient, moments updated in place; ``warmup_poly`` across its
warmup ramp, its decay and past its end, for powers 1 and 2; ``ct_cast``
(identity forward, the cotangent rounded to ``dtype`` and back).
Tolerances: updates and moments atol 1e-6 (fp32, the same formulas);
the schedule bit-equal (no transcendental function in it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import lamb as jax_lamb
from repro.optim import warmup_poly as jax_warmup_poly
from repro.train.precision import ct_cast as jax_ct_cast
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import lamb, warmup_poly
from repro_torch.train.precision import ct_cast

torch.set_num_threads(1)   # see tests/test_torch_paged_grad.py


@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
def test_lamb_updates_match_jax(weight_decay):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"w": f(6, 5), "bias": np.zeros(5, np.float32),
              "blocks": [{"m": f(3, 4), "scale": f(4)}, {"m": f(3, 4),
                                                          "scale": f(4)}]}
    grads = [jax.tree.map(lambda a: f(*a.shape), params) for _ in range(3)]
    grads[1]["blocks"][1]["m"] = np.zeros((3, 4), np.float32)
    jopt = jax_lamb(jax_warmup_poly(1e-2, 2, 10), weight_decay=weight_decay)
    topt = lamb(warmup_poly(1e-2, 2, 10), weight_decay=weight_decay)
    jp, jstate = params, jopt.init(params)
    tp = jax.tree.map(torch.as_tensor, params)
    tstate = topt.init(tp)
    mu = tree_leaves(tstate["mu"])
    for g in grads:
        jupd, jstate = jopt.update(g, jstate, jp)
        tupd, tstate = topt.update(jax.tree.map(torch.as_tensor, g), tstate, tp)
        for a, b in zip(tree_leaves(tupd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        for a, b in zip(tree_leaves(tstate["nu"]), jax.tree.leaves(jstate["nu"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        jp = jax.tree.map(lambda p, u: p + u, jp, jupd)
        tp = jax.tree.map(lambda p, u: p + u, tp, tupd)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    # in place: the state holds the tensors init made
    assert all(a is b for a, b in zip(mu, tree_leaves(tstate["mu"])))


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_warmup_poly_matches_jax(power):
    jfn = jax_warmup_poly(3.75e-3, 10, 40, power=power)
    tfn = warmup_poly(3.75e-3, 10, 40, power=power)
    for s in range(0, 50):
        want = np.float32(jfn(jnp.int32(s)))
        got = tfn(torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        assert got == want, s
    assert float(tfn(torch.tensor(40))) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ct_cast_rounds_the_cotangent(dtype):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64).astype(np.float32)
    ct = (rng.standard_normal(64) * 1e-3 + 1.0).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = ct_cast(tx, dtype)
    assert torch.equal(y, tx)
    (g,) = torch.autograd.grad(y, tx, torch.tensor(ct))
    assert g.dtype == torch.float32
    _, vjp = jax.vjp(lambda a: jax_ct_cast(a, jdt), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert not np.array_equal(g.numpy(), ct)      # the cast did round
